"""Shared linear autoencoder for the Gaussian UML experiment.

The port of uml_tpu/models/shared_autoencoder.py (capability parity with
Gaussian_experiment/model.py:5-59): per-modality input/output Linear
heads around a *shared* MLP encoder (Linear-ReLU-Linear) and decoder
(Linear-ReLU-Linear); MSE reconstruction loss per modality.  The shared
encoder/decoder is what lets unpaired Y data shape the representation X
uses.  The eight ``nn.Linear`` carry uml_tpu's names
(models/convert.py::shared_autoencoder_from_jax maps its tree).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from uml_tpu_torch.models.initializers import torch_linear_bias_for, torch_linear_weight


class SharedAutoencoder(nn.Module):
    def __init__(self, dim_obs: int, dim_common: int, dim_latent: int):
        super().__init__()
        self.dim_obs, self.dim_common, self.dim_latent = dim_obs, dim_common, dim_latent
        self.in_head_x = nn.Linear(dim_obs, dim_common)
        self.in_head_y = nn.Linear(dim_obs, dim_common)
        self.enc1 = nn.Linear(dim_common, dim_latent)
        self.enc2 = nn.Linear(dim_latent, dim_latent)
        self.dec1 = nn.Linear(dim_latent, dim_latent)
        self.dec2 = nn.Linear(dim_latent, dim_common)
        self.out_head_x = nn.Linear(dim_common, dim_obs)
        self.out_head_y = nn.Linear(dim_common, dim_obs)

    def init_random(self, generator: torch.Generator) -> "SharedAutoencoder":
        """torch.nn.Linear's init distributions (models/initializers.py),
        drawn from ``generator`` layer by layer, weight then bias."""
        with torch.no_grad():
            for layer in self.children():
                fan_in = layer.weight.shape[1]
                layer.weight.copy_(torch_linear_weight(generator, layer.weight.shape))
                layer.bias.copy_(torch_linear_bias_for(fan_in)(generator,
                                                               layer.bias.shape))
        return self

    def encode(self, z):
        return self.enc2(F.relu(self.enc1(z)))

    def decode(self, latent):
        return self.dec2(F.relu(self.dec1(latent)))

    def forward(self, x=None, y=None):
        """-> (loss_x, loss_y, recon_x, recon_y) like model.py:29-49; a
        missing modality's loss is a 0-d zero and its recon None."""
        zero = torch.zeros((), device=self.enc1.weight.device)
        loss_x = loss_y = zero
        recon_x = recon_y = None
        if x is not None:
            recon_x = self.out_head_x(self.decode(self.encode(self.in_head_x(x))))
            loss_x = torch.mean((recon_x - x) ** 2)
        if y is not None:
            recon_y = self.out_head_y(self.decode(self.encode(self.in_head_y(y))))
            loss_y = torch.mean((recon_y - y) ** 2)
        return loss_x, loss_y, recon_x, recon_y

    def get_embeddings(self, x=None, y=None):
        """Shared-encoder latents per modality (model.py:51-59)."""
        emb_x = self.encode(self.in_head_x(x)) if x is not None else None
        emb_y = self.encode(self.in_head_y(y)) if y is not None else None
        return emb_x, emb_y
