"""The PyTorch port stands alone: it imports nothing of the JAX package.

An AST walk over every module of `passl_tpu_torch/` and `chip_smoke.py`
refuses any import of `passl_tpu`, `passl_tpu.*` or `jax`; a fresh
interpreter that imports the port's entry points finds neither in
`sys.modules`; the port's own copies of the data pipeline give the JAX
package's batches bit for bit from the same config and seed; and its copy of
`models/utils/pos_embed.py` is the JAX file under its header, its tables bit
for bit.
"""
import ast
import copy
import os
import subprocess
import sys

import numpy as np
import pytest

from passl_tpu.data import build_dataloader as jax_build_dataloader
from passl_tpu_torch.data import build_dataloader
from passl_tpu_torch.utils import cfg_util

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("passl_tpu", "jax")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "passl_tpu_torch")):
        out += [os.path.join(root, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def _imported(tree: ast.AST):
    """Absolute module names of every import statement in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_module_imports_nothing_of_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [name for name in _imported(tree) if _forbidden(name)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_import_walk_catches_what_it_should():
    tree = ast.parse("import jax.numpy as jnp\nfrom passl_tpu.data import x\n"
                     "def f():\n    import passl_tpu\nfrom . import passl_tpu_torch\n"
                     "import passl_tpu_torch.ops\nimport jaxlib_not_jax\n")
    assert [n for n in _imported(tree) if _forbidden(n)] == ["jax.numpy", "passl_tpu.data",
                                                             "passl_tpu"]


def test_entry_points_load_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import passl_tpu_torch\n"
            "import passl_tpu_torch.engine.engine, passl_tpu_torch.engine.inference\n"
            "import passl_tpu_torch.tools.train, passl_tpu_torch.tools.export\n"
            "import passl_tpu_torch.tools.predict, passl_tpu_torch.tools.eval\n"
            "import passl_tpu_torch.models, passl_tpu_torch.data\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'passl_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PASSL_PLATFORM"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ------------------------------------------------------------ the data copies


def _synthetic(config_path, size, image_size, batch, *overrides):
    """The config's Train loader block on a SyntheticDataset (its transforms,
    sampler and batch transforms kept), small enough for the CPU."""
    config = cfg_util.get_config(os.path.join(REPO, "configs", "classification", config_path),
                                 overrides=list(overrides))
    dl = copy.deepcopy(dict(config["DataLoader"]["Train"]))
    dl["dataset"] = {"name": "SyntheticDataset", "size": size, "image_size": image_size,
                     "num_classes": 1000, "transform": dl["dataset"]["transform"]}
    dl["sampler"] = {**dl["sampler"], "batch_size": batch}
    dl["loader"] = {"num_workers": 2, "prefetch": 2}
    return dl, int(config["Global"]["seed"])


def _first_batches(build, dl, seed, n=2):
    loader = build(copy.deepcopy(dl), "Train", seed=seed)
    loader.set_epoch(1)
    out = []
    for b in loader:
        out.append(b)
        if len(out) == n:
            break
    loader.close()
    return out


@pytest.mark.parametrize("config, size, image_size, batch", [
    ("cait_tiny_synthetic.yaml", 64, 32, 16),
    # TimmAutoAugment, RandomErasing and the Mixup/Cutmix TransformOpSampler
    ("vit_base_patch16_224_in1k.yaml", 16, 224, 8),
])
def test_port_loader_gives_the_jax_loaders_batches_bitwise(config, size, image_size, batch):
    dl, seed = _synthetic(config, size, image_size, batch)
    want = _first_batches(jax_build_dataloader, dl, seed)
    got = _first_batches(build_dataloader, dl, seed)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert type(g) is type(w) and len(g) == len(w)
        for a, b in zip(g, w):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    images, labels = got[0][0], got[0][1]
    assert images.shape == (batch, image_size, image_size, 3)
    if "vit_base" in config:  # soft labels from Mixup/Cutmix
        assert labels.shape == (batch, 1000) and labels.dtype == np.float32


# ---------------------------------------------------------- the model copies


def test_pos_embed_copy_is_the_jax_file_under_its_header():
    """`passl_tpu_torch/models/utils/pos_embed.py` is the JAX package's file
    (it imports only numpy) under two header lines naming where it came from,
    and its four functions give the JAX package's tables bit for bit."""
    from passl_tpu.models.utils import pos_embed as jax_pos
    from passl_tpu_torch.models.utils import pos_embed as port_pos

    with open(os.path.join(REPO, "passl_tpu", "models", "utils", "pos_embed.py")) as f:
        jax_src = f.read()
    with open(os.path.join(REPO, "passl_tpu_torch", "models", "utils", "pos_embed.py")) as f:
        lines = f.read().split("\n")
    assert lines[0].startswith("# Copied from passl_tpu/models/utils/pos_embed.py")
    assert "\n".join(lines[2:]) == jax_src
    grid = np.stack(np.meshgrid(np.arange(7.0), np.arange(7.0)), 0).reshape(2, 1, 7, 7)
    for got, want in (
            (port_pos.get_1d_sincos_pos_embed_from_grid(64, np.arange(9.0)),
             jax_pos.get_1d_sincos_pos_embed_from_grid(64, np.arange(9.0))),
            (port_pos.get_2d_sincos_pos_embed_from_grid(64, grid),
             jax_pos.get_2d_sincos_pos_embed_from_grid(64, grid)),
            (port_pos.get_2d_sincos_pos_embed(768, 14, cls_token=True),
             jax_pos.get_2d_sincos_pos_embed(768, 14, cls_token=True)),
            (port_pos.mocov3_2d_sincos_pos_embed(768, 14, 14),
             jax_pos.mocov3_2d_sincos_pos_embed(768, 14, 14))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
