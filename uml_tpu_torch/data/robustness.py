"""Robustness noise suites for every modality.

The port of uml_tpu/data/robustness.py: host numpy, so the same code.

Capability parity with MultiBench/robustness/* — the perturbation families
used to build the 10/11-level noisy test loaders:

  timeseries (timeseries_robust.py:7-25): white noise, random drop,
      structured drop
  tabular    (tabular_robust.py:7-21):    drop, adjacent swap
  audio      (audio_robust.py:7-23):      AWGN, random/structured dropout
  text       (text_robust.py:8-41):       typo family on raw words (swap,
      random-mid shuffle, qwerty, sticky keys, omission)
  visual     (visual_robust.py:9-40):     grayscale, contrast, inversion,
      white balance, colorize, salt&pepper, gaussian, rotate, flip, crop

Implementations are numpy-vectorized where the reference loops per element;
the sampled distributions match (Bernoulli(p) gates, N(0, p) noise).  The
reference's GloVe re-embedding of noisy text (affect get_data.py:332-347)
requires torchtext + downloaded vectors; in this zero-egress build noisy
text is returned as strings and the caller embeds with whatever encoder is
in use.
"""

from __future__ import annotations

import re

import numpy as np

# ---------------------------------------------------------------------------
# timeseries
# ---------------------------------------------------------------------------


def white_noise(data, p, rng=None):
    """One N(0, p) scalar offset per element of ``data``.

    At the nesting the reference's robust_test path uses
    (``add_timeseries_noise([whole_split_array], ...)``, get_data.py:353),
    each element is a full [T, D] sample, so a WHOLE SAMPLE gets a single
    shared offset (timeseries_robust.py:28-36 'data[i][time] += normal').
    """
    rng = rng or np.random
    return [np.asarray(d, dtype=np.float64) + rng.normal(0, p) for d in data]


def random_drop(data, p, rng=None):
    """Drop individual entries with probability p (elementwise — the
    reference's _random_drop_helper recurses to scalar level)."""
    rng = rng or np.random
    out = []
    for d in data:
        d = np.array(d, dtype=np.float64)
        mask = rng.random(d.shape) < p
        d[mask] = 0.0
        out.append(d)
    return out


def structured_drop(data, p, rng=None):
    """Zero whole elements of ``data`` with probability p — whole samples
    at the reference robust_test nesting (timeseries_robust.py:72-80)."""
    rng = rng or np.random
    out = []
    for d in data:
        d = np.array(d, dtype=np.float64)
        if rng.random() < p:
            d[:] = 0.0
        out.append(d)
    return out


def add_timeseries_noise(tests, noise_level=0.3, gaussian_noise=True,
                         rand_drop=True, struct_drop=True, rng=None):
    """tests: list of series-collections (parity with timeseries_robust.py)."""
    out = tests
    if gaussian_noise:
        out = [white_noise(series, noise_level, rng) for series in out]
    if rand_drop:
        out = [random_drop(series, noise_level, rng) for series in out]
    if struct_drop:
        out = [structured_drop(series, noise_level, rng) for series in out]
    return out


# ---------------------------------------------------------------------------
# tabular
# ---------------------------------------------------------------------------


def tabular_drop(data, p, rng=None):
    rng = rng or np.random
    data = np.array(data, dtype=np.float64)
    data[rng.random(data.shape) < p] = 0.0
    return data


def tabular_swap(data, p, rng=None):
    """Swap adjacent elements with probability p.

    NOTE: the reference's swap (tabular_robust.py:40-49) overwrites both
    slots with the previous value (a duplicate, not a swap); this is a
    true swap.
    """
    rng = rng or np.random
    data = np.array(data, dtype=np.float64)
    for i in range(len(data)):
        for j in range(1, data.shape[1]):
            if rng.random() < p:
                data[i, j], data[i, j - 1] = data[i, j - 1], data[i, j]
    return data


def add_tabular_noise(tests, noise_level=0.3, drop=True, swap=True, rng=None):
    data = np.array(tests, dtype=np.float64)
    if drop:
        data = tabular_drop(data, noise_level, rng)
    if swap:
        data = tabular_swap(data, noise_level, rng)
    return data


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------


def additive_white_gaussian_noise(signal, noise_level, rng=None):
    rng = rng or np.random
    signal = np.asarray(signal, dtype=np.float64)
    return signal + rng.normal(0, noise_level, signal.shape[0]).reshape(
        (-1,) + (1,) * (signal.ndim - 1))


def audio_structured_dropout(signal, p, step=10, rng=None):
    rng = rng or np.random
    res = np.array(signal, dtype=np.float64)
    for i in range(len(res) - step + 1):
        if np.any(res[i] != 0) and rng.random() < p:
            res[i : i + step] = 0
    return res


def audio_random_dropout(signal, p, rng=None):
    return audio_structured_dropout(signal, p, step=1, rng=rng)


def _randint(rng, n: int) -> int:
    """Uniform [0, n) on legacy RandomState, Generator, or np.random."""
    if hasattr(rng, "integers"):
        return int(rng.integers(n))
    return int(rng.randint(n))


def add_audio_noise(tests, noise_level=0.3, noises=None, rng=None):
    rng = rng or np.random
    if noises is None:
        noises = [additive_white_gaussian_noise, audio_random_dropout,
                  audio_structured_dropout]
    tests = np.asarray(tests)
    out = np.zeros(tests.shape)
    for i in range(len(tests)):
        if rng.random() <= noise_level:
            out[i] = noises[_randint(rng, len(noises))](
                tests[i], noise_level, rng=rng)
    return out


# ---------------------------------------------------------------------------
# text (typo family on raw strings)
# ---------------------------------------------------------------------------

_QWERTY = {
    "q": "w", "w": "qes", "e": "wrd", "r": "etf", "t": "rgy", "y": "tuh",
    "u": "yij", "i": "uok", "o": "ipl", "p": "o", "a": "qsz", "s": "awdxz",
    "d": "sefxc", "f": "drgcv", "g": "fthvb", "h": "gyjbn", "j": "huknm",
    "k": "jilm", "l": "ko", "z": "asx", "x": "zsdc", "c": "xdfv",
    "v": "cfgb", "b": "vghn", "n": "bhmj", "m": "njk",
}


def _normalize_text(text: str) -> list[str]:
    text = text.lower()
    text = re.sub(r"<br />", r" ", text).strip()
    text = re.sub(r"^https?:\/\/.*[\r\n]*", " L ", text, flags=re.MULTILINE)
    text = re.sub(r"[\~\*\+\^`_#\[\]|]", r" ", text).strip()
    text = re.sub(r"[0-9]+", r" N ", text).strip()
    text = re.sub(r"([/\'\-\.?!\(\)\",:;])", r" \1 ", text).strip()
    return text.split()


def _last_char(word: str) -> int:
    for i in range(len(word) - 1, -1, -1):
        if word[i].isalnum():
            return i
    return -1


def swap_letter(word, rng=None):
    rng = rng or np.random
    last = _last_char(word)
    pos = _randint(rng, last - 2) + 1
    return word[:pos] + word[pos + 1] + word[pos] + word[pos + 2:]


def random_mid(word, rng=None):
    rng = rng or np.random
    last = _last_char(word)
    mid = list(word[1:last])
    rng.shuffle(mid)
    return word[0] + "".join(mid) + word[last:]


def qwerty_typo(word, rng=None):
    rng = rng or np.random
    last = _last_char(word)
    order = np.arange(last + 1)
    rng.shuffle(order)
    for pos in order:
        if word[pos] in _QWERTY:
            options = _QWERTY[word[pos]]
            key = options[_randint(rng, len(options))]
            return word[:pos] + key + word[pos + 1:]
    return word


def sticky_keys(word, num_sticky=1, rng=None):
    rng = rng or np.random
    last = _last_char(word)
    order = np.arange(last + 1)
    rng.shuffle(order)
    for i in range(num_sticky):
        p = order[i]
        word = word[:p] + word[p] + word[p:]
    return word


def omission(word, num_omit=1, rng=None):
    rng = rng or np.random
    last = _last_char(word)
    for _ in range(num_omit):
        omit = _randint(rng, last - 1) + 1
        word = word[:omit] + word[omit + 1:]
        last -= 1
    return word


def add_text_noise(tests, noise_level=0.3, swap=True, rand_mid=True,
                   typo=True, sticky=True, omit=True, rng=None):
    """list of raw strings -> noisy strings (text_robust.py:8-41)."""
    rng = rng or np.random
    noises = []
    if swap:
        noises.append(lambda w: swap_letter(w, rng))
    if rand_mid:
        noises.append(lambda w: random_mid(w, rng))
    if typo:
        noises.append(lambda w: qwerty_typo(w, rng))
    if sticky:
        noises.append(lambda w: sticky_keys(w, rng=rng))
    if omit:
        noises.append(lambda w: omission(w, rng=rng))
    out = []
    for text in tests:
        words = []
        for word in _normalize_text(text):
            if _last_char(word) > 3 and rng.random() <= noise_level:
                words.append(noises[_randint(rng, len(noises))](word))
            else:
                words.append(word)
        out.append(" ".join(words))
    return out


# ---------------------------------------------------------------------------
# visual
# ---------------------------------------------------------------------------


def add_visual_noise(tests, noise_level=0.3, gray=True, contrast=True,
                     inv=True, temp=True, color=True, s_and_p=True, gaus=True,
                     rot=True, flip=True, crop=True, rng=None):
    """Image perturbation chain (visual_robust.py:9-55); tests are HxW[xC]
    uint8 arrays."""
    from PIL import Image, ImageEnhance, ImageOps

    rng = rng or np.random

    def maybe(fn):
        def wrapped(img):
            return fn(img) if rng.random() <= noise_level else img
        return wrapped

    def white_balance(img):
        arr = np.asarray(img, dtype=np.float64)
        shift = rng.uniform(-30, 30)
        arr[..., 0] = np.clip(arr[..., 0] + shift, 0, 255)   # warm/cool red
        arr[..., 2] = np.clip(arr[..., 2] - shift, 0, 255)   # opposite blue
        return Image.fromarray(arr.astype(np.uint8))

    def colorize_img(img):
        arr = np.asarray(img, dtype=np.float64)
        tint = rng.uniform(0.8, 1.2, size=3)
        return Image.fromarray(np.clip(arr * tint, 0, 255).astype(np.uint8))

    def salt_and_pepper(img):
        arr = np.asarray(img).copy()
        mask = rng.random(arr.shape[:2])
        arr[mask < noise_level / 2] = 0
        arr[mask > 1 - noise_level / 2] = 255
        return Image.fromarray(arr)

    def gaussian_img(img):
        arr = np.asarray(img, dtype=np.float64)
        arr += rng.normal(0, 255 * noise_level / 3, arr.shape)
        return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))

    def rotate_img(img):
        return img.rotate(rng.uniform(-30, 30))

    def crop_img(img):
        w, h = img.size
        dx, dy = int(w * noise_level / 2), int(h * noise_level / 2)
        if dx == 0 or dy == 0:
            return img
        left, top = rng.randint(dx + 1), rng.randint(dy + 1)
        return img.crop((left, top, w - dx + left, h - dy + top)).resize((w, h))

    chain = []
    if gray:
        chain.append(maybe(lambda im: ImageOps.grayscale(im).convert("RGB")))
    if contrast:
        chain.append(maybe(lambda im: ImageEnhance.Contrast(im).enhance(0.5)))
    if inv:
        chain.append(maybe(ImageOps.invert))
    if temp:
        chain.append(maybe(white_balance))
    if color:
        chain.append(maybe(colorize_img))
    if s_and_p:
        chain.append(maybe(salt_and_pepper))
    if gaus:
        chain.append(maybe(gaussian_img))
    if rot:
        chain.append(maybe(rotate_img))
    if flip:
        chain.append(maybe(ImageOps.mirror))
    if crop:
        chain.append(maybe(crop_img))

    out = []
    for arr in tests:
        img = Image.fromarray(arr)
        mode = img.mode
        img = img.convert("RGB")
        for fn in chain:
            img = fn(img)
        out.append(np.array(img.convert(mode)))
    return out
