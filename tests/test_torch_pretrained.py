"""`Global.pretrained_model` in the PyTorch port against the JAX package.

The port's loader (`passl_tpu_torch/utils/io.py load_pretrained`) follows
the JAX loader (`passl_tpu/utils/io.py:198-271`): an entry the file lacks
keeps the model's init, a shape mismatch keeps the init (a new head), a
`pos_embed` of another grid is resized bicubically, keys the model lacks
are ignored, and the report of what was loaded drives the EMA towers'
re-sync. Each test feeds both packages the same numpy arrays: the JAX side
a flax msgpack file, the port the same arrays converted into a torch
`state_dict` file.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import passl_tpu.models.vision_transformer as jax_vit
from passl_tpu.engine import Engine as JaxEngine
from passl_tpu.utils.io import load_pretrained_into
from passl_tpu_torch.data import to_device
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models.vision_transformer import VisionTransformer, interpolate_pos_embed
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.tools import export
from passl_tpu_torch.utils import cfg_util, io
from passl_tpu_torch.utils.convert import flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FT_CFG = os.path.join(REPO, "configs", "classification", "vit_tiny_ft48_synthetic.yaml")
# pos_embed: the same f32 resize weights summed in another order (float64
# here, XLA's f32 einsum there), of the largest entry
POS_TOL = 1e-6
TINY = dict(patch_size=4, embed_dim=16, depth=1, num_heads=2)


@pytest.mark.parametrize("old,new", [(14, 24), (24, 14)], ids=["grow", "shrink"])
@pytest.mark.parametrize("prefix", [1, 0])
def test_interpolate_pos_embed_matches_jax(old, new, prefix):
    """jax.image.resize's bicubic is Keys' cubic (a = -0.5) with half-pixel
    centres, widened when it shrinks (antialias); torch's own bicubic
    (a = -0.75, no antialias) is not the same function."""
    x = np.random.RandomState(old + prefix).randn(1, old * old + prefix, 16).astype(np.float32)
    want = np.asarray(jax_vit.interpolate_pos_embed(jnp.asarray(x), new, num_prefix=prefix))
    got = interpolate_pos_embed(torch.from_numpy(x), new, num_prefix=prefix)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (1, new * new + prefix, 16)
    np.testing.assert_array_equal(got[:, :prefix].numpy(), x[:, :prefix])
    assert np.abs(got.numpy() - want).max() <= POS_TOL * np.abs(want).max()


def _jax_params(img_size, num_classes, seed):
    model = jax_vit.VisionTransformer(img_size=img_size, num_classes=num_classes, **TINY)
    x = jnp.zeros((1, img_size, img_size, 3))
    return jax.device_get(model.init(jax.random.PRNGKey(seed), x, train=False)["params"])


def test_loader_keeps_a_new_head_and_resizes_the_grid_as_jax_does(tmp_path):
    """A tiny ViT checkpoint (14 x 14 grid, 10 classes, one extra entry) into a
    model with a 24 x 24 grid and 5 classes: both packages give the same
    params (pos_embed resized, the head kept at init, the extra key ignored)."""
    src = _jax_params(56, 10, seed=0)
    fresh = _jax_params(96, 5, seed=1)
    extra = np.ones((3,), np.float32)
    jax_file = tmp_path / "src.params"
    jax_file.write_bytes(serialization.to_bytes({**src, "extra": {"bias": extra}}))
    report_jax = {}
    want = load_pretrained_into(str(jax_file), fresh, report=report_jax)

    model = VisionTransformer(img_size=96, num_classes=5, **TINY)
    model.load_state_dict(flax_to_torch(fresh, model))  # the same init on both sides
    init = {k: v.clone() for k, v in model.state_dict().items()}
    port_file = tmp_path / "src.pt"
    torch.save({**flax_to_torch(src, VisionTransformer(img_size=56, num_classes=10, **TINY)),
                "extra.bias": torch.from_numpy(extra)}, port_file)
    report = io.load_pretrained(model, str(port_file))

    got, ref = model.state_dict(), flax_to_torch(want, model)
    for k, v in got.items():
        if k == "pos_embed":
            assert np.abs(v.numpy() - ref[k].numpy()).max() <= POS_TOL * ref[k].abs().max().item()
        else:
            assert torch.equal(v, ref[k]), k
    assert torch.equal(got["head.weight"], init["head.weight"])
    assert torch.equal(got["head.bias"], init["head.bias"])
    assert report["loaded"] == set(got) - {"head.weight", "head.bias"}
    assert sorted(report["mismatched"]) == ["head.bias", "head.weight"]
    assert report["extra"] == ["extra.bias"] and report["missing"] == []
    assert len(report["loaded"]) == len(report_jax["loaded"])


def test_loader_keeps_the_init_of_what_the_file_lacks(tmp_path):
    model = VisionTransformer(img_size=32, num_classes=5, **TINY)
    init_module(model, torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    part = {k: torch.full_like(v, 0.5) for k, v in init.items() if k.startswith("blocks.")}
    torch.save(part, tmp_path / "part.pt")
    report = io.load_pretrained(model, str(tmp_path / "part.pt"))
    assert report["loaded"] == set(part) and set(report["missing"]) == set(init) - set(part)
    for k, v in model.state_dict().items():
        assert torch.equal(v, part[k] if k in part else init[k]), k
    with pytest.raises(NotImplementedError, match="flax msgpack"):
        io.load_pretrained(model, str(tmp_path / "backbone.params"))


def _ft_config(tmp_path, *overrides):
    return cfg_util.get_config(FT_CFG, overrides=[f"Global.output_dir={tmp_path}",
                                                  "Global.max_train_step=1", *overrides])


def test_vit_resolution_finetune_config_loads_as_in_jax(tmp_path):
    """The 384-finetune recipe's tiny twin (configs/classification/
    vit_tiny_ft48_synthetic.yaml: 48 px from a 32 px pretrain): the JAX and
    the port's engines load the same 32 px, 100-class checkpoint; the
    grid goes 4 x 4 -> 6 x 6, the head keeps each engine's own init, and the
    port then trains a step."""
    cfg = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)
    model = jax_vit.VisionTransformer(num_classes=100, **cfg)
    src = jax.device_get(model.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)),
                                    train=False)["params"])
    jax_file = tmp_path / "pretrain32.params"
    jax_file.write_bytes(serialization.to_bytes(src))
    port_file = tmp_path / "pretrain32.pt"
    torch.save(flax_to_torch(src, VisionTransformer(num_classes=100, **cfg)), port_file)

    je = JaxEngine(_ft_config(tmp_path / "jax", f"Global.pretrained_model={jax_file}"),
                   mode="train")
    e = Engine(_ft_config(tmp_path / "port", f"Global.pretrained_model={port_file}"),
               mode="train", device="cpu")
    fresh = Engine(_ft_config(tmp_path / "fresh"), mode="train", device="cpu")
    want = flax_to_torch(jax.device_get(je.state.params), e.model)
    got = e.model.state_dict()
    head = {"head.weight", "head.bias"}
    assert e.pretrained_report["loaded"] == set(got) - head
    assert sorted(e.pretrained_report["mismatched"]) == sorted(head)
    assert got["pos_embed"].shape == (1, 37, 64)
    for k, v in got.items():
        if k in head:
            assert torch.equal(v, fresh.model.state_dict()[k]), k
        elif k == "pos_embed":
            assert (v - want[k]).abs().max().item() <= POS_TOL * want[k].abs().max().item()
        else:
            assert torch.equal(v, want[k]), k
    batch = next(iter(e.train_dataloader))
    loss = float(e.train_step(e.state, to_device(batch, e.device))["loss"])
    assert np.isfinite(loss)
    for eng in (e, fresh):
        eng.close()
    je.train_dataloader.close()


def test_export_loads_a_partial_file_over_the_seed_init(tmp_path):
    """tools/export with Global.pretrained_model of another head and grid:
    what the file fills is taken, the head keeps the seed's init."""
    cfg = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)
    src = VisionTransformer(num_classes=100, **cfg)
    init_module(src, torch.Generator().manual_seed(9))
    torch.save(src.state_dict(), tmp_path / "pretrain32.pt")
    out = export.main(["-c", FT_CFG, "-o", f"Global.output_dir={tmp_path / 'art'}",
                       "-o", f"Global.pretrained_model={tmp_path / 'pretrain32.pt'}"])
    got = torch.load(out, weights_only=True)
    seed_init = build_model(dict(cfg_util.get_config(FT_CFG)["Model"]))
    init_module(seed_init, torch.Generator().manual_seed(42))
    want_pos = interpolate_pos_embed(src.state_dict()["pos_embed"], 6)
    torch.testing.assert_close(got["pos_embed"], want_pos, rtol=0, atol=0)
    for k, v in got.items():
        if k.startswith("head."):
            assert torch.equal(v, seed_init.state_dict()[k]), k
        elif k != "pos_embed":
            assert torch.equal(v, src.state_dict()[k]), k
