"""Probe classifiers for self-supervised evaluation.

The port of uml_tpu/train/probes.py.  Parity with MultiBench/train.py:
96-102: mosi uses a StandardScaler + LogisticRegression(liblinear,
max_iter=1000) pipeline, other datasets plain LogisticRegression
(max_iter=200); kNN probes available.  uml_tpu builds them with
scikit-learn, which the card's machine does not have, so the port carries
its own, on numpy and scipy (which it has), with sklearn's objectives:

* ``LogisticRegression`` (lbfgs): mean log-loss (binomial for two
  classes, multinomial above) + 1 / (2 C n) |W|^2, the intercept not
  penalized, minimized by scipy's L-BFGS-B from zeros with sklearn's
  options (gtol ``tol``, ftol 64 eps, maxls 50, ``max_iter``), the loss
  and gradient in the features' dtype as sklearn computes them, so the
  two take the same iterates up to rounding;
* the liblinear form (mosi): 1/2 |[w, b]|^2 + C sum log-loss, the
  intercept penalized (intercept_scaling 1), minimized to convergence
  (liblinear's trust-region Newton stops at a tolerance; the optimum is
  the same);
* ``StandardScaler`` (population std, zero std -> 1) and ``make_pipeline``;
* ``KNeighborsClassifier`` (5 neighbours, Euclidean, majority vote, ties
  to the smallest label).

tests/test_torch_multibench.py holds each against scikit-learn's.

``device_probe_scores`` is the device-resident logistic probe: full-batch
Adam on the convex objective (mean cross-entropy + l2 * |W|^2 on
standardized features), one Adam iteration per step of uml_tpu's
``lax.scan``, with the same lr, steps and l2, on the features' device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import optimize


def _binomial_loss_grad(y, raw):
    """sklearn's closed form of the half binomial loss and its gradient
    (``closs_grad_half_binomial``), in float64 per sample."""
    raw = raw.astype(np.float64)
    y = y.astype(np.float64)
    neg = np.exp(np.minimum(raw, -2.0))    # read only where raw <= -2
    pos = np.exp(-np.maximum(raw, -2.0))   # read only where raw > -2
    lo, mid, hi = raw <= -37, raw <= -2, raw <= 18
    loss = np.where(lo, neg - y * raw,
                    np.where(mid, np.log1p(neg) - y * raw,
                             np.where(hi, np.log1p(pos) + (1 - y) * raw,
                                      pos + (1 - y) * raw)))
    grad = np.where(lo, neg - y,
                    np.where(mid, ((1 - y) * neg - y) / (1 + neg),
                             ((1 - y) - y * pos) / (1 + pos)))
    return loss, grad


def _multinomial_loss_grad(y, raw):
    """The half multinomial loss (log-sum-exp minus the true class's raw
    score) and its gradient (softmax minus one-hot), in float64."""
    raw = raw.astype(np.float64)
    top = raw.max(axis=1, keepdims=True)
    e = np.exp(raw - top)
    total = e.sum(axis=1, keepdims=True)
    rows = np.arange(len(y))
    loss = np.log(total[:, 0]) + top[:, 0] - raw[rows, y]
    grad = e / total
    grad[rows, y] -= 1.0
    return loss, grad


class LogisticRegression:
    """sklearn's ``LogisticRegression()`` (C = 1, tol 1e-4, an l2 penalty)
    for the probes: ``solver`` "lbfgs" (the default) or "liblinear"
    (binary)."""

    def __init__(self, max_iter: int = 100, solver: str = "lbfgs"):
        if solver not in ("lbfgs", "liblinear"):
            raise ValueError(f"solver {solver!r}: expected lbfgs or liblinear")
        self.max_iter, self.solver = max_iter, solver

    def fit(self, X, y):
        X = np.asarray(X)
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(np.float64)
        y = np.asarray(y)
        self.classes_, idx = np.unique(y, return_inverse=True)
        n, d = X.shape
        k = len(self.classes_)
        if k < 2:
            raise ValueError(f"needs at least 2 classes, got {self.classes_}")
        if self.solver == "liblinear":
            if k != 2:
                raise ValueError("liblinear takes two classes")
            w = self._fit_liblinear(X.astype(np.float64), np.where(idx == 1, 1.0, -1.0))
            self.coef_, self.intercept_ = w[None, :-1], w[-1:]
            return self
        l2 = 1.0 / n
        if k == 2:
            target = (idx == 1).astype(X.dtype)

            def loss_grad(w):
                coef = w[:-1]
                raw = X @ coef.astype(X.dtype) + X.dtype.type(w[-1])
                loss_i, grad_i = _binomial_loss_grad(target, raw)
                grad_i = grad_i.astype(X.dtype) / X.dtype.type(n)
                loss = float(np.sum(loss_i.astype(X.dtype)) / n) + float(
                    0.5 * l2 * (coef @ coef))
                g = np.empty_like(w)
                g[:-1] = X.T @ grad_i + l2 * coef
                g[-1] = np.sum(grad_i)
                return loss, g

            w0 = np.zeros(d + 1)
        else:
            def loss_grad(w):
                W = w.reshape((k, d + 1), order="F")
                coef = W[:, :-1]
                raw = X @ coef.astype(X.dtype).T + W[:, -1].astype(X.dtype)
                loss_i, grad_i = _multinomial_loss_grad(idx, raw)
                grad_i = grad_i.astype(X.dtype) / X.dtype.type(n)
                loss = float(np.sum(loss_i.astype(X.dtype)) / n) + float(
                    0.5 * l2 * np.sum(coef * coef))
                g = np.empty((k, d + 1), order="F")
                g[:, :-1] = grad_i.T @ X + l2 * coef
                g[:, -1] = grad_i.sum(axis=0)
                return loss, g.ravel(order="F")

            w0 = np.zeros(k * (d + 1))
        res = optimize.minimize(loss_grad, w0, method="L-BFGS-B", jac=True,
                                options={"maxiter": self.max_iter, "maxls": 50,
                                         "gtol": 1e-4,
                                         "ftol": 64 * np.finfo(float).eps})
        w = res.x.astype(X.dtype)
        if k == 2:
            self.coef_, self.intercept_ = w[None, :-1], w[-1:]
        else:
            W = w.reshape((k, d + 1), order="F")
            self.coef_, self.intercept_ = W[:, :-1], W[:, -1]
        return self

    def _fit_liblinear(self, X, sign):
        """min 1/2 |w|^2 + sum log(1 + exp(-sign (X w + b))) over [w, b],
        the bias penalized like a weight; scaled by 1 / n for L-BFGS."""
        n = len(X)
        Xb = np.hstack([X, np.ones((n, 1))])
        scale = 1.0 / n

        def loss_grad(w):
            margin = sign * (Xb @ w)
            loss = np.logaddexp(0.0, -margin)
            coeff = -sign * np.exp(-np.logaddexp(0.0, margin))   # -sign * sigmoid(-margin)
            return (0.5 * scale * (w @ w) + loss.mean(),
                    scale * w + Xb.T @ coeff / n)

        res = optimize.minimize(loss_grad, np.zeros(Xb.shape[1]), method="L-BFGS-B",
                                jac=True, options={"maxiter": self.max_iter,
                                                   "gtol": 1e-10, "ftol": 0.0,
                                                   "maxls": 50})
        return res.x

    def decision_function(self, X):
        # numpy's promotion, as sklearn's: float32 features and lbfgs's
        # float32 coefficients score in float32, liblinear's float64 ones in
        # float64
        scores = np.asarray(X) @ self.coef_.T + self.intercept_
        return scores[:, 0] if scores.shape[1] == 1 else scores

    def predict(self, X):
        scores = self.decision_function(X)
        idx = (scores > 0).astype(np.int64) if scores.ndim == 1 else scores.argmax(1)
        return self.classes_[idx]

    def score(self, X, y):
        return float(np.mean(self.predict(X) == np.asarray(y)))


class StandardScaler:
    """Center and scale each feature by its mean and population std
    (statistics in float64, a zero std scales by 1)."""

    def fit(self, X):
        X64 = np.asarray(X, dtype=np.float64)
        self.mean_ = X64.mean(axis=0)
        std = X64.std(axis=0)
        self.scale_ = np.where(std == 0, 1.0, std)
        return self

    def transform(self, X):
        X = np.array(X, dtype=np.result_type(np.asarray(X).dtype, np.float32))
        X -= self.mean_.astype(X.dtype)
        X /= self.scale_.astype(X.dtype)
        return X


class Pipeline:
    """A scaler, then a classifier (sklearn's ``make_pipeline`` of two)."""

    def __init__(self, scaler, clf):
        self.scaler, self.clf = scaler, clf

    def fit(self, X, y):
        self.clf.fit(self.scaler.fit(X).transform(X), y)
        return self

    def predict(self, X):
        return self.clf.predict(self.scaler.transform(X))

    def score(self, X, y):
        return float(np.mean(self.predict(X) == np.asarray(y)))


class KNeighborsClassifier:
    """5 nearest neighbours by Euclidean distance, majority vote."""

    n_neighbors = 5

    def fit(self, X, y):
        self.X_ = np.asarray(X, dtype=np.float64)
        self.classes_, self.y_ = np.unique(np.asarray(y), return_inverse=True)
        return self

    def predict(self, X):
        X = np.asarray(X, dtype=np.float64)
        d2 = ((X ** 2).sum(1)[:, None] - 2 * X @ self.X_.T + (self.X_ ** 2).sum(1)[None])
        near = np.argsort(d2, axis=1, kind="stable")[:, : self.n_neighbors]
        votes = np.zeros((len(X), len(self.classes_)), np.int64)
        np.add.at(votes, (np.arange(len(X))[:, None], self.y_[near]), 1)
        return self.classes_[votes.argmax(1)]

    def score(self, X, y):
        return float(np.mean(self.predict(X) == np.asarray(y)))


def make_classifier(classifier_type: str, ds_name: str):
    if classifier_type == "logistic":
        if ds_name == "mosi":
            return Pipeline(StandardScaler(),
                            LogisticRegression(max_iter=1000, solver="liblinear"))
        return LogisticRegression(max_iter=200)
    if classifier_type == "knn":
        return KNeighborsClassifier()
    raise ValueError(f"Unsupported classifier type: {classifier_type}")


def probe_scores(train_X, train_y, val_X, val_y, test_X, test_y,
                 ds_name: str, classifier_type: str = "logistic"):
    """fit on train, -> (val_score, test_score)."""
    clf = make_classifier(classifier_type, ds_name)
    clf.fit(train_X, train_y)
    return clf.score(val_X, val_y), clf.score(test_X, test_y)


# ---------------------------------------------------------------------------
# device-resident logistic probe
# ---------------------------------------------------------------------------


def _fit_logistic(X, y, n_classes: int, steps: int = 300, lr: float = 0.5,
                  l2: float = 1e-4):
    """-> ((W, b), mu, sd): ``steps`` Adam iterations (optax.adam's betas
    and eps) from zeros on the standardized ``X``."""
    mu = X.mean(0)
    sd = X.std(0, correction=0) + 1e-8
    Xn = (X - mu) / sd
    W = torch.zeros(X.shape[1], n_classes, device=X.device, requires_grad=True)
    b = torch.zeros(n_classes, device=X.device, requires_grad=True)
    opt = torch.optim.Adam([W, b], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    with torch.enable_grad():
        for _ in range(steps):
            opt.zero_grad(set_to_none=False)
            loss = F.cross_entropy(Xn @ W + b, y) + l2 * torch.sum(W ** 2)
            loss.backward()
            opt.step()
    return (W.detach(), b.detach()), mu, sd


def device_probe_scores(train_X, train_y, val_X, val_y, test_X, test_y,
                        n_classes=None):
    """Logistic probe on the training features' device (numpy: the CPU);
    returns (val_acc, test_acc)."""
    device = train_X.device if isinstance(train_X, torch.Tensor) else "cpu"

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    labels = t(train_y, torch.long)
    if n_classes is None:
        n_classes = int(labels.max()) + 1
    (W, b), mu, sd = _fit_logistic(t(train_X, torch.float32), labels, n_classes)

    def acc(X, y):
        logits = (t(X, torch.float32) - mu) / sd @ W + b
        return float((logits.argmax(-1) == t(y, torch.long)).float().mean())

    return acc(val_X, val_y), acc(test_X, test_y)
