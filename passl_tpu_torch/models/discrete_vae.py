"""The discrete VAE, the image tokenizer of BEiT's and CAE's targets
(counterpart of `passl_tpu/models/discrete_vae.py`).

The encoder (JAX `:50-57`): per downsampling, a 4 x 4 stride-2 conv (each
followed by a ReLU) and `num_resblocks` `_ResBlock`s, the width going from
`hidden_dim / 4` up to `hidden_dim`; `to_logits` (1 x 1) gives the
`vocab_size` logits of an `h x w` token grid, h = H / 2^downsamples. The
decoder (JAX `:59-67`): per stage `num_resblocks` `_ResBlock`s and a 4 x 4
stride-2 transposed conv (ReLU after), the width halving down to 64, then
`to_pixels` (1 x 1) to 3 channels. `codebook` holds the `[vocab_size,
hidden_dim]` embedding (flax `codebook/embedding`, normal with std
hidden_dim^-1/2 as flax's `nn.Embed` draws it). Images are NHWC at the
public functions, NCHW inside. BEiT's and CAE's tokenizer only tokenizes, so
flax never creates its codebook and decoder: `with_decoder=False` builds it
so (a dVAE checkpoint's codebook and decoder are then keys it ignores).

`tokenize` is the frozen tokenizer's path: the argmax over the vocabulary,
[N, h w] int64. `decode` maps token ids back to images. The forward trains
the dVAE on its own: the gumbel-softmax sample of the logits at
`temperature` (with `hard`, straight-through: the decoder reads the one-hot
code, the gradient flows through the soft sample), the reconstruction's
mean squared error plus `kl_weight` times the KL divergence of the
code distribution from the uniform one. The gumbel uniforms come from one
module-level function, `gumbel_uniforms(shape, generator, device)`, looked
up at call time, which draws from the generator the train step hands over
(tests hand it the JAX package's draws). In eval the code is the argmax.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Conv, ConvTranspose
from .base import register_model

DtypeLike = Union[str, torch.dtype]


def gumbel_uniforms(shape: tuple, generator: torch.Generator,
                    device: torch.device) -> torch.Tensor:
    """The f32 uniforms of one gumbel-softmax sample of logits of `shape`."""
    return torch.rand(shape, generator=generator, device=device)


class _ResBlock(nn.Module):
    """x + conv2(relu(conv1(relu(x)))), 3 x 3 convs; a 1 x 1 `skip` where the
    width changes."""

    def __init__(self, in_channels: int, dim: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv(in_channels, dim, 3, padding=1, dtype=dtype)
        self.conv2 = Conv(dim, dim, 3, padding=1, dtype=dtype)
        self.skip = Conv(in_channels, dim, 1, dtype=dtype) if in_channels != dim else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(F.relu(self.conv1(F.relu(x))))
        return (self.skip(x) if self.skip is not None else x) + y


class _Codebook(nn.Module):
    """flax `nn.Embed`: the `embedding` table [vocab, dim], at init normal with
    std dim^-1/2 (flax's variance scaling over the fan in, dim)."""

    def __init__(self, vocab_size: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab_size, dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        tinit.normal_(self.embedding, std=self.embedding.shape[1] ** -0.5, generator=generator)


@register_model
class DiscreteVAE(nn.Module):
    """images [N, H, W, 3] NHWC (or the loader's (images, labels)) ->
    {"loss", "recon_loss", "kl"}, scalars in f32."""

    def __init__(self, vocab_size: int = 8192, hidden_dim: int = 256, num_resblocks: int = 2,
                 downsamples: int = 3, kl_weight: float = 0.0, hard: bool = False,
                 gumbel_temperature: float = 1.0, with_decoder: bool = True,
                 dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.hidden_dim = hidden_dim
        self.kl_weight = kl_weight
        self.hard = hard
        self.gumbel_temperature = gumbel_temperature
        dim, cin = hidden_dim // 4, 3
        for i in range(downsamples):
            setattr(self, f"enc_down{i}", Conv(cin, dim, 4, stride=2, padding=1, dtype=dtype))
            for j in range(num_resblocks):
                setattr(self, f"enc_res{i}_{j}", _ResBlock(dim, dim, dtype))
            cin, dim = dim, min(dim * 2, hidden_dim)
        self.to_logits = Conv(cin, vocab_size, 1, dtype=dtype)
        self._encoder = [n for n, _ in self.named_children() if n.startswith("enc_")]
        self._decoder = []
        if not with_decoder:
            return
        self.codebook = _Codebook(vocab_size, hidden_dim)
        dim = hidden_dim
        for i in range(downsamples):
            for j in range(num_resblocks):
                setattr(self, f"dec_res{i}_{j}", _ResBlock(dim, dim, dtype))
            out = max(dim // 2, 64)
            setattr(self, f"dec_up{i}", ConvTranspose(dim, out, 4, 2, dtype=dtype))
            dim = out
        self.to_pixels = Conv(dim, 3, 1, dtype=dtype)
        self._decoder = [n for n, _ in self.named_children() if n.startswith("dec_")]

    def encode_logits(self, imgs: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] -> the logits [N, h, w, vocab_size] at the compute dtype."""
        x = imgs.permute(0, 3, 1, 2)
        for name in self._encoder:
            x = getattr(self, name)(x)
            if name.startswith("enc_down"):
                x = F.relu(x)
        return self.to_logits(x).permute(0, 2, 3, 1)

    def tokenize(self, imgs: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] -> token ids [N, h w] int64 (the frozen tokenizer's path)."""
        ids = torch.argmax(self.encode_logits(imgs), dim=-1)
        return ids.reshape(ids.shape[0], -1)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        """Codes [N, h, w, hidden] -> images [N, H, W, 3]."""
        x = z.permute(0, 3, 1, 2)
        for name in self._decoder:
            x = getattr(self, name)(x)
            if name.startswith("dec_up"):
                x = F.relu(x)
        return self.to_pixels(x).permute(0, 2, 3, 1)

    def decode(self, ids: torch.Tensor, grid: int) -> torch.Tensor:
        """Token ids [N, grid^2] -> images [N, H, W, 3]."""
        z = self.codebook.embedding[ids].reshape(ids.shape[0], grid, grid, self.hidden_dim)
        return self._decode(z)

    def forward(self, batch, generator: Optional[torch.Generator] = None,
                temperature: Optional[float] = None) -> dict:
        if temperature is None:
            temperature = self.gumbel_temperature
        if not self._decoder:
            raise ValueError("DiscreteVAE: built without its decoder (with_decoder=False), "
                             "it only tokenizes")
        imgs = batch[0] if isinstance(batch, (tuple, list)) else batch
        logits = self.encode_logits(imgs)
        v = logits.shape[-1]
        if self.training:
            if generator is None:
                raise ValueError("DiscreteVAE: training draws its gumbel noise from the train "
                                 "state's generator; none was given")
            u = gumbel_uniforms(tuple(logits.shape), generator, logits.device)
            g = -torch.log(-torch.log(u + 1e-9) + 1e-9)
            soft = torch.softmax((logits + g) / temperature, dim=-1)
            if self.hard:
                hard = F.one_hot(torch.argmax(soft, dim=-1), v).to(soft.dtype)
                soft = soft + (hard - soft).detach()
        else:
            soft = F.one_hot(torch.argmax(logits, dim=-1), v).to(logits.dtype)
        emb = self.codebook.embedding.to(logits.dtype)
        ct = torch.promote_types(soft.dtype, emb.dtype)  # jnp.einsum's promotion
        recon = self._decode(torch.matmul(soft.to(ct), emb.to(ct)))
        at = torch.promote_types(recon.dtype, torch.float32)
        recon_loss = torch.mean(torch.square(recon.to(at) - imgs.to(at)))
        logp = torch.log_softmax(logits.to(at), dim=-1)
        kl = torch.mean(torch.sum(torch.exp(logp) * (logp + math.log(v)), dim=-1))
        return {"loss": recon_loss + self.kl_weight * kl, "recon_loss": recon_loss, "kl": kl}
