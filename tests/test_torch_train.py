"""Training path of the PyTorch port: Engine -> loop -> train step -> AdamW,
TimmCosine and the global-norm clip -> checkpoint -> eval and export.

The slice as a whole: the JAX Engine's initial params for
configs/classification/cait_tiny_synthetic.yaml, carried over with
utils.convert as the port's `Global.pretrained_model`, then 4 train steps of
both engines on the same loader batches, in f32 on the CPU. Also a
save/resume round trip against an uninterrupted run, train -> export ->
serve, the exact eval count over a ragged tail, micro-batch accumulation,
and the config keys the port refuses.
"""
import os

import jax
import numpy as np
import pytest
import torch

from passl_tpu.engine import Engine as JaxEngine
from passl_tpu_torch.data import to_device
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.engine.inference import Predictor
from passl_tpu_torch.tools import export
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "classification", "cait_tiny_synthetic.yaml")
CLIP = "Optimizer.grad_clip={'name': 'ClipGradByGlobalNorm', 'clip_norm': 1.0}"
# LayerScale at 0.5 instead of 1e-5, so that the blocks' gradients are not
# scaled away and every part of the model shows in the comparison
PARITY = ["Model.init_values=0.5", CLIP]


def _config(tmp_path, *overrides):
    return cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}", *overrides])


def _params(engine):
    return {k: v.detach().clone() for k, v in engine.model.state_dict().items()}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's init (as a torch state_dict file), its first 4 loader
    batches, and its metrics and params after 4 train steps on them."""
    tmp = tmp_path_factory.mktemp("jax")
    je = JaxEngine(_config(tmp, *PARITY), mode="train")
    params0 = jax.device_get(je.state.params)
    port = Engine(_config(tmp, *PARITY), mode="train", device="cpu")  # for the names and shapes
    init_file = os.path.join(str(tmp), "init.pt")
    torch.save(flax_to_torch(params0, port.model), init_file)
    je.train_dataloader.set_epoch(1)
    batches = []
    for b in je.train_dataloader:
        batches.append(b)
        if len(batches) == 4:
            break
    metrics = []
    for b in batches:
        je.state, m = je.train_step(je.state, je.shard_batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
    final = flax_to_torch(jax.device_get(je.state.params), port.model)
    je.train_dataloader.close()
    return init_file, batches, metrics, final


def test_tiny_cait_tracks_the_jax_train_step(tmp_path, jax_run):
    init_file, batches, jax_metrics, jax_final = jax_run
    e = Engine(_config(tmp_path, *PARITY, f"Global.pretrained_model={init_file}"),
               mode="train", device="cpu")
    # the loader tolerates a partial file: the converted one must fill every entry
    assert e.pretrained_report["loaded"] == set(e.model.state_dict())
    assert not e.pretrained_report["extra"]
    init = _params(e)
    for b, want in zip(batches, jax_metrics):
        got = {k: float(v) for k, v in e.train_step(e.state, to_device(b, e.device)).items()}
        assert set(got) == set(want)
        # one f32 forward and backward, summed in another order than XLA's
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["CELoss"], want["CELoss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)  # f64 here, f32 in JAX
        assert got["grad_norm"] > 1.0  # the clip acts
    assert e.state.step == 4
    total_lr = sum(m["lr"] for m in jax_metrics)
    for name, p in _params(e).items():
        d_port, d_jax = p - init[name], jax_final[name] - init[name]
        # AdamW divides by |g| + eps, so an element whose gradient is near eps
        # moves by an amount that rounding decides: hold every element to a
        # tenth of the summed lr, and each tensor's update to 2e-3 relative
        assert (d_port - d_jax).abs().max().item() <= 0.1 * total_lr, name
        if name.endswith("attn.k.bias") and name.startswith("blocks_token_only"):
            continue  # softmax is shift-invariant: its gradient is zero up to rounding
        assert (d_port - d_jax).norm() <= 2e-3 * d_jax.norm(), name


def _train(tmp_path, *overrides):
    e = Engine(_config(tmp_path, "Model.drop_path_rate=0.1", "Global.print_batch_step=1",
                       *overrides), mode="train", device="cpu")
    e.train()
    return e


def test_resume_gives_the_uninterrupted_run(tmp_path):
    straight = _train(tmp_path / "a", "Global.max_train_step=4")
    first = _train(tmp_path / "b", "Global.max_train_step=2")
    assert first.state.step == 2 and os.path.exists(tmp_path / "b" / "latest.pt")
    resumed = _train(tmp_path / "c", "Global.max_train_step=4",
                     f"Global.checkpoint={tmp_path / 'b' / 'latest.pt'}")
    assert resumed.state.step == 4
    # the mid-epoch resume skips the 2 trained batches and restores the
    # DropPath generator, the AdamW moments and the step: bitwise the same
    assert [h["loss"] for h in resumed.train_loop.history] == \
        [h["loss"] for h in straight.train_loop.history[2:]]
    a, b = _params(straight), _params(resumed)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(straight.state.generator.get_state(), resumed.state.generator.get_state())


def test_save_cadence_best_and_garbage_collection(tmp_path):
    """latest and epoch_N every save_interval epochs, best after an eval that
    improves, only the newest max_num_latest_checkpoint epoch_N kept."""
    import json

    e = _train(tmp_path, "Global.epochs=3", "Global.save_interval=1",
               "Global.max_num_latest_checkpoint=2", "Global.eval_during_train=True")
    assert e.state.step == 3 * e.steps_per_epoch
    names = sorted(p.name for p in tmp_path.glob("*.pt"))
    assert names == ["best.pt", "epoch_2.pt", "epoch_3.pt", "latest.pt"]
    assert not (tmp_path / "epoch_1.states").exists()
    with open(tmp_path / "latest.states") as f:
        assert json.load(f)["step"] == e.state.step
    with open(tmp_path / "best.states") as f:
        assert set(json.load(f)["metric"]) == {"metric"}


def test_drop_path_masks_come_from_the_state_generator(tmp_path):
    e = Engine(_config(tmp_path, "Model.drop_path_rate=0.5", "Model.init_values=0.5"),
               mode="train", device="cpu")
    batch = to_device(next(iter(e.train_dataloader)), e.device)
    rng = e.state.generator.get_state()
    first = e.train_step.forward_backward(e.state, batch)["loss"]
    e.state.generator.set_state(rng)
    torch.manual_seed(123)  # the global RNG plays no part
    again = e.train_step.forward_backward(e.state, batch)["loss"]
    assert torch.equal(first, again)
    other = e.train_step.forward_backward(e.state, batch)["loss"]  # the generator moved on
    assert not torch.equal(first, other)
    e.close()


def test_full_model_ema_follows_the_jax_rule(tmp_path):
    """EMA {decay, thres_steps}: the shadow copies the params while step <
    thres_steps, then ema = decay * ema + (1 - decay) * params after each
    update (`passl_tpu/engine/steps.py:222-229`). The JAX engine's own EMA
    cannot run on the CPU mesh (its shadow aliases the params, which the
    donated step refuses), so the rule is held here on the port's own params."""
    e = Engine(_config(tmp_path, "EMA={'decay': 0.75, 'thres_steps': 1}"), mode="train",
               device="cpu")
    want = None
    for i, b in enumerate(e.train_dataloader):
        e.train_step(e.state, to_device(b, e.device))
        p = _params(e)
        want = p if i == 0 else {k: 0.75 * want[k] + 0.25 * p[k] for k in p}
        if i == 2:
            break
    for k, v in e.state.ema_params.items():
        torch.testing.assert_close(v, want[k], rtol=1e-6, atol=1e-7)  # f32, another order
    assert any(not torch.equal(e.state.ema_params[k], p[k]) for k in p)
    top1 = e.eval_loop.run()
    assert {"top1", "top5", "top1_ema", "top5_ema"} == set(e.eval_loop.last_metrics)
    assert np.isfinite(top1)
    e.close()


def test_accum_steps_sum_the_micro_batch_gradients(tmp_path):
    grads, losses = [], []
    for accum in (1, 2):
        e = Engine(_config(tmp_path, f"Global.accum_steps={accum}"), mode="train", device="cpu")
        batch = to_device(next(iter(e.train_dataloader)), e.device)
        losses.append(float(e.train_step.forward_backward(e.state, batch)["loss"]))
        grads.append({n: p.grad.clone() for n, p in e.model.named_parameters()})
        e.close()
    # the mean over two halves is the mean over the whole, in another order
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-4, atol=1e-8)


def test_train_export_serve(tmp_path):
    e = _train(tmp_path / "run", "Global.max_train_step=2")
    out = tmp_path / "artifact"
    export.main(["-c", TINY_CFG, "-o", f"Global.output_dir={out}",
                 "-o", f"Global.checkpoint={tmp_path / 'run' / 'latest.pt'}"])
    pred = Predictor(str(out), name="CaiT", device="cpu")
    images = np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32)
    got = pred.predict(images)
    e.model.eval()
    with torch.inference_mode():
        want = e.model(torch.from_numpy(images)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_eval_counts_a_ragged_tail_exactly(tmp_path):
    e = Engine(_config(tmp_path, "DataLoader.Eval.dataset.size=100"), mode="eval", device="cpu")
    top1 = e.eval()
    assert e.eval_loop.last_metrics.keys() == {"top1", "top5"}
    images, labels = zip(*(e.eval_dataloader.dataset[i] for i in range(100)))
    with torch.inference_mode():
        logits = e.model(torch.from_numpy(np.stack(images)))
    pred = logits.argmax(-1).numpy()
    assert top1 == pytest.approx(float(np.mean(pred == np.asarray(labels))), abs=1e-7)


@pytest.mark.parametrize("override, error", [
    ("DistributedStrategy={'sharding_degree': 2}", NotImplementedError),
    ("DistributedStrategy={'recompute': {'layerlist_interval': 1}}", NotImplementedError),
    ("Global.hooks=[{'name': 'x'}]", NotImplementedError),
    ("Optimizer.name='MomentumLARC'", NotImplementedError),
    ("Global.checkpoint='./output/latest.ckpt'", NotImplementedError),
])
def test_engine_refuses_what_it_does_not_port(tmp_path, override, error):
    e = None
    with pytest.raises(error):
        e = Engine(_config(tmp_path, override), mode="train", device="cpu")
        e.train()
    assert e is None or e.state.step == 0


def test_engine_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(_config(tmp_path), mode="train", device="cuda")
