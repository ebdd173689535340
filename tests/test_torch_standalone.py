"""The PyTorch port stands alone: it imports nothing of the JAX package.

An AST walk over every module of `passl_tpu_torch/` and `chip_smoke.py`
refuses any import of `passl_tpu`, `passl_tpu.*` or `jax`; a fresh
interpreter that imports the port's entry points finds neither in
`sys.modules`; the port's own copies of the data pipeline give the JAX
package's batches bit for bit from the same config and seed, the captioned
datasets' included; its copy of `models/utils/pos_embed.py` is the JAX file
under its header, its tables bit for bit; its copy of `data/masking.py` is the JAX file
under its header, its masks and BEiT's and CAE's two-view batches bit for
bit; its copy of `data/tokenizer.py` is the JAX file under its header, reading its own copy
of the BPE vocabulary (the JAX asset's sha256), its tokens bit for bit; its copy
of `engine/hooks.py` is the JAX file under its header; and its `ProfilerOptions`
is the JAX class's source.
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


# ----------------------------------------------------------- the mask copy


def test_masking_copy_is_the_jax_file_under_its_header():
    """`passl_tpu_torch/data/masking.py` is the JAX package's file under two
    header lines, its three transforms registered; BEiT's block masks (75 of
    196, and CAE's 98) and the uniform masks are the JAX generators' bitwise
    from the same `random` and numpy seeds."""
    import random

    from passl_tpu.data import masking as jax_masking
    from passl_tpu_torch.data import masking as port_masking
    from passl_tpu_torch.data.transforms import TRANSFORMS

    with open(os.path.join(REPO, "passl_tpu", "data", "masking.py")) as f:
        jax_src = f.read()
    with open(os.path.join(REPO, "passl_tpu_torch", "data", "masking.py")) as f:
        lines = f.read().split("\n")
    assert lines[0].startswith("# Copied from passl_tpu/data/masking.py")
    assert "\n".join(lines[2:]) == jax_src
    assert TRANSFORMS["BEiTTwoViewsWithMask"] is port_masking.BEiTTwoViewsWithMask
    assert TRANSFORMS["MaskingGenerator"] is port_masking.MaskingGenerator
    assert TRANSFORMS["RandomMaskingGenerator"] is port_masking.RandomMaskingGenerator
    for args in ((14, 75, 16), (14, 98, 16), (4, 6, 2)):
        draws = []
        for mod in (jax_masking, port_masking):
            random.seed(7)
            gen = mod.MaskingGenerator(*args)
            draws.append(np.stack([gen() for _ in range(200)]))
        np.testing.assert_array_equal(draws[0], draws[1])
        assert draws[1].sum(1).max() <= args[1]
    draws = []
    for mod in (jax_masking, port_masking):
        np.random.seed(3)
        gen = mod.RandomMaskingGenerator(14, 0.75)
        draws.append(np.stack([gen() for _ in range(20)]))
    np.testing.assert_array_equal(draws[0], draws[1])


@pytest.mark.parametrize("config", ["beit/beit_base_patch16_224_in1k.yaml",
                                    "cae/cae_base_patch16_224_in1k.yaml"])
def test_port_loader_gives_the_two_view_mask_batches_bitwise(config):
    """BEiT's and CAE's `BEiTTwoViewsWithMask` (the shared crop, flip and
    jitter, the two normalizations, the block mask) through both loaders on
    synthetic images: the (view, tokenizer view, mask) batches and labels equal."""
    cfg = cfg_util.get_config(os.path.join(REPO, "configs", config))
    dl = copy.deepcopy(dict(cfg["DataLoader"]["Train"]))
    dl["dataset"] = {"name": "SyntheticDataset", "size": 8, "image_size": 64,
                     "num_classes": 10, "transform": dl["dataset"]["transform"]}
    dl["sampler"] = {**dl["sampler"], "batch_size": 4}
    dl["loader"] = {"num_workers": 2, "prefetch": 2}
    want = _first_batches(jax_build_dataloader, dl, 42)
    got = _first_batches(build_dataloader, dl, 42)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        (views, labels), (jviews, jlabels) = g, w
        np.testing.assert_array_equal(labels, jlabels)
        assert len(views) == len(jviews) == 3
        for a, b in zip(views, jviews):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert views[0].shape == views[1].shape == (4, 224, 224, 3)
        assert views[2].shape == (4, 196) and views[2].dtype == np.int32


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


# ------------------------------------------------------- the tokenizer copy

CAPTIONS = ["a photo of a cat", "hello world", "a diagram", "A photo of a DOG.",
            "a cat sat on the mat", " ".join(["word"] * 200), "café naïve 日本",
            "&amp;quot;it's&quot; 12 o'clock -- don't", ""]


def test_tokenizer_copy_is_the_jax_file_under_its_header_with_its_vocabulary():
    """`passl_tpu_torch/data/tokenizer.py` is the JAX package's file under two
    header lines, and reads its own copy of the BPE vocabulary, byte for byte
    the JAX package's asset."""
    import hashlib

    from passl_tpu_torch.data import tokenizer as port_tok

    with open(os.path.join(REPO, "passl_tpu", "data", "tokenizer.py")) as f:
        jax_src = f.read()
    with open(os.path.join(REPO, "passl_tpu_torch", "data", "tokenizer.py")) as f:
        lines = f.read().split("\n")
    assert lines[0].startswith("# Copied from passl_tpu/data/tokenizer.py")
    assert "\n".join(lines[2:]) == jax_src
    assert port_tok.DEFAULT_BPE_PATH == os.path.join(REPO, "passl_tpu_torch", "data", "assets",
                                                     "bpe_simple_vocab_16e6.txt.gz")
    digests = []
    for pkg in ("passl_tpu", "passl_tpu_torch"):
        with open(os.path.join(REPO, pkg, "data", "assets", "bpe_simple_vocab_16e6.txt.gz"),
                  "rb") as f:
            digests.append(hashlib.sha256(f.read()).hexdigest())
    assert digests[0] == digests[1]


@pytest.mark.parametrize("bpe", ["vendored", "byte-level"])
def test_tokens_are_the_jax_tokenizers_bitwise(bpe):
    """tests/test_clip.py's strings, the ten StructuredTextImageDataset class
    captions of every template and a few edge cases, with the vendored
    vocabulary and with the byte-level fallback (`bpe_path=""`)."""
    from passl_tpu.data.datasets import StructuredTextImageDataset
    from passl_tpu.data.tokenizer import SimpleTokenizer as JaxTok
    from passl_tpu_torch.data.tokenizer import SimpleTokenizer as PortTok

    path = None if bpe == "vendored" else ""
    texts = CAPTIONS + [t.format(w) for t in StructuredTextImageDataset.TEMPLATES
                        for w in StructuredTextImageDataset.CLASS_WORDS]
    jt, pt = JaxTok(bpe_path=path), PortTok(bpe_path=path)
    assert pt.vocab_size == jt.vocab_size == (49408 if bpe == "vendored" else 514)
    for ctx in (77, 32):
        got, want = pt.tokenize(texts, ctx), jt.tokenize(texts, ctx)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert [pt.decode(pt.encode(t)) for t in texts] == [jt.decode(jt.encode(t)) for t in texts]


@pytest.mark.parametrize("name", ["StructuredTextImageDataset", "SyntheticTextImageDataset",
                                  "TextImageDataset"])
def test_port_loader_gives_the_captioned_batches_bitwise(name, tmp_path):
    """The captioned datasets through both loaders: the {"image", "text"}
    batches equal, the tokens int32."""
    from PIL import Image

    transform = [{"RandomResizedCrop": {"size": 24, "scale": [0.6, 1.0]}},
                 {"RandFlipImage": {"prob": 0.5}},
                 {"NormalizeImage": {"scale": 1 / 255.0, "mean": [0.5] * 3, "std": [0.25] * 3}}]
    if name == "TextImageDataset":
        rs = np.random.RandomState(0)
        with open(tmp_path / "pairs.tsv", "w") as f:
            for i in range(8):
                Image.fromarray(rs.randint(0, 256, (28, 30, 3), np.uint8)).save(
                    tmp_path / f"{i}.png")
                f.write(f"{i}.png\ta photo of a {CAPTIONS[i % 5]} #{i}\n")
        dataset = {"data_root": str(tmp_path), "anno_path": str(tmp_path / "pairs.tsv"),
                   "context_length": 16}
    elif name == "StructuredTextImageDataset":
        dataset = {"size": 8, "image_size": 32, "num_classes": 10, "noise": 0.2,
                   "context_length": 32}
    else:
        dataset = {"size": 8, "image_size": 32, "context_length": 16, "vocab_size": 256}
    dl = {"dataset": {"name": name, "transform": transform, **dataset},
          "sampler": {"batch_size": 4, "shuffle": True, "drop_last": True},
          "loader": {"num_workers": 0}}
    want = _first_batches(jax_build_dataloader, dl, 42)
    got = _first_batches(build_dataloader, dl, 42)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"image", "text"}
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])
        assert g["text"].dtype == np.int32 and g["image"].shape == (4, 24, 24, 3)


# ------------------------------------------------------ the token-label copy


def test_token_label_copy_is_the_jax_file_under_its_header():
    """`passl_tpu_torch/data/token_label.py` is the JAX package's file under two
    header lines, and its datasets register by name on first use, as in JAX."""
    from passl_tpu_torch.data import build_dataset, token_label
    from passl_tpu_torch.data.datasets import DATASETS

    with open(os.path.join(REPO, "passl_tpu", "data", "token_label.py")) as f:
        jax_src = f.read()
    with open(os.path.join(REPO, "passl_tpu_torch", "data", "token_label.py")) as f:
        lines = f.read().split("\n")
    assert lines[0].startswith("# Copied from passl_tpu/data/token_label.py")
    assert "\n".join(lines[2:]) == jax_src
    ds = build_dataset({"name": "SyntheticTokenLabelDataset", "size": 4})
    assert isinstance(ds, token_label.SyntheticTokenLabelDataset)
    assert DATASETS["LVViT_ImageNet"] is DATASETS["LVViTImageNetDataset"] is (
        token_label.LVViTImageNetDataset)


def _token_label_tree(root, n=8, size=32, k=3, grid=8):
    """A tiny ImageNet list of n images in two classes with .npy label maps
    [2, k, grid, grid] beside them (made from a seed): the left half of each
    image black and its right half white, the maps' first index 0 on the left
    half of the grid and 1 on the right."""
    from PIL import Image

    rs = np.random.RandomState(0)
    os.makedirs(root / "img" / "a")
    os.makedirs(root / "img" / "b")
    lines = []
    for i in range(n):
        rel = os.path.join("a" if i % 2 == 0 else "b", f"{i}.png")
        img = np.zeros((size, size, 3), np.uint8)
        img[:, size // 2:] = 255
        Image.fromarray(img).save(root / "img" / rel)
        lab = np.zeros((2, k, grid, grid), np.float32)
        lab[0] = rs.rand(k, grid, grid)
        lab[0] /= lab[0].sum(0, keepdims=True)
        lab[1] = rs.randint(2, 10, (k, grid, grid))
        lab[1, 0] = (np.arange(grid) >= grid // 2)[None, :]
        os.makedirs(os.path.dirname(root / "maps" / rel), exist_ok=True)
        np.save(root / "maps" / (os.path.splitext(rel)[0] + ".npy"), lab)
        lines.append(f"{rel} {i % 2}")
    (root / "list.txt").write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("name", ["SyntheticTokenLabelDataset", "LVViTImageNetDataset"])
def test_port_loader_gives_the_token_label_batches_bitwise(name, tmp_path):
    """The token-label datasets through both loaders (2 workers): the {image,
    label, token_value, token_idx} batches equal. On the image tree the joint
    crop and flip move image and label map together: where the whole image is
    taken and flipped (flip_prob 1, scale 1), the grid's left half carries the
    white half's index 1."""
    if name == "SyntheticTokenLabelDataset":
        cases = [({"size": 16, "image_size": 32, "grid_size": 4, "num_classes": 10, "topk": 3},
                  (32, 4, 3))]
    else:
        _token_label_tree(tmp_path)
        tree = {"image_root": str(tmp_path / "img"), "cls_label_path": str(tmp_path / "list.txt"),
                "label_root": str(tmp_path / "maps"), "grid_size": 4, "image_size": 16}
        cases = [(dict(tree, scale=[0.3, 1.0]), (16, 4, 3)),
                 (dict(tree, scale=[1.0, 1.0], flip_prob=1.0), (16, 4, 3))]
    for dataset, (size, grid, k) in cases:
        dl = {"dataset": {"name": name, **dataset},
              "sampler": {"batch_size": 4, "shuffle": True, "drop_last": True},
              "loader": {"num_workers": 2, "prefetch": 2}}
        want = _first_batches(jax_build_dataloader, dl, 42)
        got = _first_batches(build_dataloader, dl, 42)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"image", "label", "token_value", "token_idx"}
            for key in g:
                assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape, key
                np.testing.assert_array_equal(g[key], w[key])
            assert g["image"].shape == (4, size, size, 3)
            assert g["token_value"].shape == g["token_idx"].shape == (4, grid, grid, k)
            assert g["token_idx"].dtype == np.int32 and g["label"].dtype == np.int32
            if dataset.get("flip_prob") == 1.0:
                white = g["image"][:, :, : size // 2].mean() > g["image"][:, :, size // 2:].mean()
                assert white  # the image flipped: its white half on the left
                np.testing.assert_array_equal(g["token_idx"][..., 0],
                                              np.broadcast_to([1, 1, 0, 0], (4, grid, grid)))


# ------------------------------------------------ the hooks and profiler copies


def test_hooks_copy_is_the_jax_file_under_its_header():
    """`passl_tpu_torch/engine/hooks.py` is the JAX package's file under two
    header lines (its imports are relative: the port's registry and logger),
    its `IterTimerHook` registered by name."""
    from passl_tpu_torch.engine import hooks

    with open(os.path.join(REPO, "passl_tpu", "engine", "hooks.py")) as f:
        jax_src = f.read()
    with open(os.path.join(REPO, "passl_tpu_torch", "engine", "hooks.py")) as f:
        lines = f.read().split("\n")
    assert lines[0].startswith("# Copied from passl_tpu/engine/hooks.py")
    assert "\n".join(lines[2:]) == jax_src
    assert hooks.HOOKS.get("IterTimerHook") is hooks.IterTimerHook
    assert [type(h).__name__ for h in hooks.build_hooks(
        [{"name": "IterTimerHook", "priority": 60}, {"name": "IterTimerHook", "priority": 5}])] \
        == ["IterTimerHook"] * 2


def test_profiler_options_copy_is_the_jax_class():
    """`ProfilerOptions` of `passl_tpu_torch/utils/profiler.py` is the JAX
    class's source as it is, the module headed by the file it came from;
    `add_profiler_step` is the port's own, on torch.profiler."""
    import inspect

    from passl_tpu.utils import profiler as jax_profiler
    from passl_tpu_torch.utils import profiler

    with open(os.path.join(REPO, "passl_tpu_torch", "utils", "profiler.py")) as f:
        first = f.readline()
    assert first.startswith("# `ProfilerOptions` copied from passl_tpu/utils/profiler.py")
    assert inspect.getsource(profiler.ProfilerOptions) == inspect.getsource(
        jax_profiler.ProfilerOptions)
    assert "torch.profiler" in inspect.getsource(profiler.add_profiler_step)
