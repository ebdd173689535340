"""Serving path of the PyTorch port: tools/export -> Predictor -> top-k.

The tiny CaiT of configs/classification/cait_tiny_synthetic.yaml: weights
made by the JAX package and carried over with utils.convert, exported by the
port's export CLI, served by the port's Predictor on the CPU, and held
against the JAX model's logits through the JAX Predictor's postprocess.
Also: the artifact's contents, the fresh-init export, the predict CLI, the
refusals, and a subprocess showing the port never loads jax.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passl_tpu.data.transforms import NormalizeImage
from passl_tpu.engine.inference import Predictor as JaxPredictor
from passl_tpu.models import cait as jax_cait
from passl_tpu_torch.engine.inference import Predictor
from passl_tpu_torch.models.cait import CaiT
from passl_tpu_torch.tools import export, predict
from passl_tpu_torch.utils.convert import flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "classification", "cait_tiny_synthetic.yaml")
TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
            depth_token_only=1, num_classes=10, th_impl="einsum")
NORMALIZE = [{"NormalizeImage": {"scale": 1.0 / 255}}]


def _export(tmp_path, *overrides):
    argv = ["-c", TINY_CFG, "-o", f"Global.output_dir={tmp_path}"]
    for o in overrides:
        argv += ["-o", o]
    return export.main(argv)


def _images(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 32, 32, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_model_and_params():
    model = jax_cait.CaiT(**TINY)
    params = jax.jit(lambda x: model.init(jax.random.PRNGKey(0), x, train=False))(
        jnp.zeros((1, 32, 32, 3)))["params"]
    # spread the near-uniform fresh-init logits so the top-5 order is decided
    params = jax.device_get(params)
    params["head"]["kernel"] = params["head"]["kernel"] * 50.0
    return model, params


def test_export_predict_matches_jax(tmp_path, jax_model_and_params):
    model, params = jax_model_and_params
    weights = tmp_path / "converted.pt"
    torch.save(flax_to_torch(params, CaiT(**TINY)), weights)
    art = _export(tmp_path / "art", f"Global.pretrained_model={weights}")
    # the loader tolerates a partial file: the artifact must hold every converted entry
    exported = torch.load(art, weights_only=True)
    converted = torch.load(weights, weights_only=True)
    assert set(exported) == set(converted)
    assert all(torch.equal(exported[k], converted[k]) for k in converted)

    pred = Predictor(str(tmp_path / "art"), name="CaiT", transform=NORMALIZE, device="cpu")
    images = list(_images(6))
    got = pred(images, topk=5)

    norm = NormalizeImage(scale=1.0 / 255)
    x = np.stack([norm(im) for im in images])
    fwd = jax.jit(lambda p, x: model.apply({"params": p}, x, train=False))
    logits = np.asarray(fwd(params, jnp.asarray(x)))
    want = JaxPredictor.postprocess(None, logits, topk=5)
    for g, w in zip(got, want):
        assert g["class_ids"] == w["class_ids"]
        # f32 on both sides, sums in another order: scores are probabilities
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-4)
    # the logits themselves, as Predictor.predict returns them
    np.testing.assert_allclose(pred.predict(pred.preprocess(images)), logits,
                               rtol=1e-4, atol=1e-4)


def test_artifact_contents(tmp_path):
    pt = _export(tmp_path, "FP16.enable=True", "FP16.dtype=bfloat16")
    assert pt == str(tmp_path / "CaiT.pt")
    with open(tmp_path / "CaiT.json") as f:
        spec = json.load(f)
    assert spec["compute_dtype"] == "bfloat16"
    assert spec["input"] == {"shape": [None, 32, 32, 3], "dtype": "float32", "layout": "NHWC"}
    assert spec["model"]["name"] == "CaiT" and "dtype" not in spec["model"]
    state = torch.load(pt, weights_only=True)
    assert state.keys() == CaiT(**TINY).state_dict().keys()
    assert {t.dtype for t in state.values()} == {torch.float32}  # params stay f32

    pred = Predictor(str(tmp_path), name="CaiT", device="cpu")
    logits = pred.predict(_images(3).astype(np.float32) / 255)
    assert logits.dtype == np.float32 and logits.shape == (3, 10)
    assert np.isfinite(logits).all()


def test_fresh_init_export_is_seeded(tmp_path, capsys):
    a = torch.load(_export(tmp_path / "a"), weights_only=True)
    assert "exporting fresh-init weights" in capsys.readouterr().out
    b = torch.load(_export(tmp_path / "b"), weights_only=True)
    c = torch.load(_export(tmp_path / "c", "Global.seed=7"), weights_only=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.weight"], c["head.weight"])


def test_export_refuses_a_jax_checkpoint(tmp_path):
    with pytest.raises(NotImplementedError, match="Global.checkpoint"):
        _export(tmp_path, "Global.checkpoint=./output/latest.ckpt")


def test_predictor_on_cuda_raises_without_a_card(tmp_path, monkeypatch):
    _export(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor(str(tmp_path), name="CaiT")  # the default device is cuda


def test_predict_cli(tmp_path, capsys):
    from PIL import Image

    _export(tmp_path / "art")
    paths = []
    for i, im in enumerate(_images(3, seed=1)):
        paths.append(str(tmp_path / f"img{i}.png"))
        Image.fromarray(im).resize((40, 40)).save(paths[-1])
    predict.main(["--model-dir", str(tmp_path / "art"), "--model-name", "CaiT",
                  "--image", *paths, "--resize", "36", "--crop", "32", "--topk", "3",
                  "--batch-size", "2", "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "\ttop3: " in ln]
    assert [ln.split("\t")[0] for ln in lines] == paths
    assert all(len(ln.split("\t")[1].split(", ")) == 3 for ln in lines)


def test_export_and_predict_a_classifier_without_img_size(tmp_path):
    """A ResNet has no `img_size`: the input spec comes from one sample of the
    config's Eval dataset (32 x 32 x 3 here), with eval_during_train off, as
    the JAX engine's export takes one loader sample."""
    import yaml

    with open(TINY_CFG) as f:
        cfg = yaml.safe_load(f)
    cfg["Model"] = {"name": "resnet18", "num_classes": 10}
    assert cfg["Global"]["eval_during_train"] is False
    path = tmp_path / "resnet18_tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    pt = export.main(["-c", str(path), "-o", f"Global.output_dir={tmp_path / 'art'}"])
    assert pt == str(tmp_path / "art" / "resnet18.pt")
    with open(tmp_path / "art" / "resnet18.json") as f:
        assert json.load(f)["input"] == {"shape": [None, 32, 32, 3], "dtype": "float32",
                                         "layout": "NHWC"}
    pred = Predictor(str(tmp_path / "art"), name="resnet18", transform=NORMALIZE, device="cpu")
    got = pred(list(_images(4)), topk=3)
    assert len(got) == 4 and all(len(g["class_ids"]) == 3 for g in got)
    logits = pred.predict(pred.preprocess(list(_images(4))))
    assert logits.shape == (4, 10) and np.isfinite(logits).all()


def test_export_spec_falls_back_to_img_size_without_a_readable_dataset(tmp_path):
    """An ImageNet list that does not exist: the model's img_size."""
    import yaml

    with open(TINY_CFG) as f:
        cfg = yaml.safe_load(f)
    cfg["Model"]["img_size"] = 48
    cfg["DataLoader"]["Eval"]["dataset"] = {
        "name": "ImageNetDataset", "image_root": str(tmp_path),
        "cls_label_path": str(tmp_path / "no_such_list.txt")}
    path = tmp_path / "cait_no_list.yaml"
    path.write_text(yaml.safe_dump(cfg))
    export.main(["-c", str(path), "-o", f"Global.output_dir={tmp_path}"])
    with open(tmp_path / "CaiT.json") as f:
        assert json.load(f)["input"]["shape"] == [None, 48, 48, 3]


_NO_JAX = r"""
import sys
import numpy as np
from passl_tpu_torch.tools import export
from passl_tpu_torch.engine.inference import Predictor
import passl_tpu_torch.models, passl_tpu_torch.utils.convert, passl_tpu_torch.utils.io
out = sys.argv[1]
export.main(["-c", sys.argv[2], "-o", "Global.output_dir=" + out])
pred = Predictor(out, name="CaiT", transform=[{"NormalizeImage": {}}], device="cpu")
res = pred(list(np.zeros((2, 32, 32, 3), np.uint8)))
assert len(res) == 2 and len(res[0]["class_ids"]) == 5
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""


def test_port_never_loads_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PASSL_PLATFORM"}
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path), TINY_CFG],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "LOADED []" in proc.stdout
