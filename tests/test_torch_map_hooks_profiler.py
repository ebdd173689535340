"""mAP and the eval loop's host-logits path, the engine hooks and the profiler
gate of the PyTorch port against the JAX package.

On the CPU: `mAP` against JAX's on seed-made scores and multi-label targets
(a class without positives, tied scores); the eval loop's host path (a metric
other than TopkAcc) over the tiny V-MoE config's eval set with a ragged tail,
from JAX's weights, against the JAX engine's; the hook events of a tiny
2-epoch run (train_begin, epoch_begin, iter_end with each global step and
its metrics, epoch_end, eval_end with the metric, train_end), in order and
with their arguments' kinds, against the JAX engine's on the same config,
the hooks sorted by priority and the built-in `IterTimerHook` among them;
`engine/hooks.py` itself is the JAX file (tests/test_torch_standalone.py);
`ProfilerOptions` against JAX's parse; `add_profiler_step` writing a
torch.profiler Chrome trace over a batch range and exiting with code 0 when
asked, by itself and from the engine's loop.
"""
import json
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.engine import hooks as port_hooks
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.metrics import METRICS, TopkAcc, mAP
from passl_tpu_torch.utils import cfg_util, profiler
from passl_tpu_torch.utils.convert import flax_to_torch
from test_torch_moco import _one_openmp_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "classification", "vmoe_tiny_synthetic.yaml")


def _scores_targets(n, c, seed):
    rs = np.random.RandomState(seed)
    scores = rs.randn(n, c).astype(np.float32)
    scores[:, 1] = np.round(scores[:, 1])  # ties
    targets = (rs.rand(n, c) < 0.3).astype(np.float32)
    targets[:, 2] = 0  # a class without positives: left out of the mean
    return scores, targets


@pytest.mark.parametrize("n, c", [(7, 4), (50, 10), (3, 3)])
def test_map_matches_jax(n, c):
    from passl_tpu.metrics import mAP as JaxMAP

    scores, targets = _scores_targets(n, c, n)
    want = JaxMAP()(scores, targets)
    got = mAP()(torch.from_numpy(scores), torch.from_numpy(targets))
    assert got == want
    assert mAP()(scores, np.zeros_like(targets)) == {"mAP": 0.0}
    assert isinstance(METRICS.get("mAP")(), mAP)


# ------------------------------------------------------- the host-logits path


class OneHotMAP:
    """mAP over the one-hot of integer labels: a metric other than TopkAcc, so
    the eval loop scores the logits on the host (the JAX class takes numpy
    arrays, the port's CPU tensors too)."""

    def __call__(self, logits, labels):
        labels = np.asarray(labels)
        logits = np.asarray(logits)
        return {**mAP()(logits, np.eye(logits.shape[1], dtype=np.float32)[labels]),
                "host_top1": float(np.mean(logits.argmax(-1) == labels))}


@pytest.fixture(scope="module")
def registered():
    """OneHotMAP and RecordHook under their names in both packages' registries."""
    from passl_tpu.engine import hooks as jax_hooks
    from passl_tpu.metrics import METRICS as JAX_METRICS

    for registry in (METRICS, JAX_METRICS):
        if "OneHotMAP" not in registry._obj_map:
            registry.register(OneHotMAP, name="OneHotMAP")
    for mod in (port_hooks, jax_hooks):
        if "RecordHook" not in mod.HOOKS._obj_map:
            mod.HOOKS.register(_record_hook(mod.Hook), name="RecordHook")
    return jax_hooks


def test_host_logits_eval_matches_the_jax_engine(tmp_path, registered):
    """100 eval images in batches of 64 (the tail padded and masked): the
    port's host path from JAX's weights gives the JAX engine's mAP and top-1,
    each the sum over batches of the metric times the batch's real count,
    over 100."""
    from passl_tpu.engine import Engine as JaxEngine

    overrides = [f"Global.output_dir={tmp_path}", "DataLoader.Eval.dataset.size=100",
                 "Metric.Eval=[{'OneHotMAP': {}}]"]
    je = JaxEngine(cfg_util.get_config(TINY_CFG, overrides=overrides), mode="eval")
    assert je.eval_metrics_step is None
    jax_map = je.eval_loop.run()  # the loop returns its first key's average
    e = Engine(cfg_util.get_config(TINY_CFG, overrides=overrides), mode="eval", device="cpu")
    assert e.eval_metrics_step is None and not isinstance(e.metric_fns[0], TopkAcc)
    import jax

    e.model.load_state_dict(flax_to_torch(jax.device_get(je.state.params), e.model))
    got_key = e.eval()
    got = e.eval_loop.last_metrics
    assert set(got) == {"mAP", "host_top1"}
    np.testing.assert_allclose(got["mAP"], jax_map, rtol=1e-5)
    # the JAX loop logs the rest: JAX's averages from its eval step, batch by
    # batch, as its loop sums them
    images, labels = zip(*(je.eval_dataloader.dataset[i] for i in range(100)))
    images, labels = np.stack(images), np.asarray(labels)
    sums = {}
    for lo in (0, 64):
        batch = images[lo:lo + 64]
        pad = np.concatenate([batch, np.repeat(batch[-1:], 64 - len(batch), axis=0)])
        logits = np.asarray(je.eval_step(je.state, je.shard_batch(pad)))[:len(batch)]
        for k, v in OneHotMAP()(logits, labels[lo:lo + 64]).items():
            sums[k] = sums.get(k, 0.0) + v * len(batch)
    want = {k: v / 100 for k, v in sums.items()}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert got_key == got["mAP"]


# ------------------------------------------------------------------ hooks


def _record_hook(base):
    class RecordHook(base):
        """Records every event with its arguments but the engine: the metrics
        as their sorted keys, the eval metric as its type."""

        events: list = []

        def __init__(self, tag: str = ""):
            self.tag = tag

        def train_begin(self, engine):
            self.events.append(("train_begin",))

        def train_end(self, engine):
            self.events.append(("train_end",))

        def epoch_begin(self, engine, epoch):
            self.events.append(("epoch_begin", epoch))

        def epoch_end(self, engine, epoch):
            self.events.append(("epoch_end", epoch))

        def iter_end(self, engine, global_step, metrics):
            self.events.append(("iter_end", global_step, tuple(sorted(metrics))))

        def eval_end(self, engine, metric):
            self.events.append(("eval_end", type(metric).__name__))

    return RecordHook


HOOK_RUN = ["DataLoader.Train.dataset.size=24", "DataLoader.Train.sampler.batch_size=8",
            "DataLoader.Eval.dataset.size=16", "DataLoader.Eval.sampler.batch_size=8",
            "Global.epochs=2", "Global.save_interval=1",
            "Global.hooks=[{'name': 'IterTimerHook'}, {'name': 'RecordHook', 'priority': 10, "
            "'tag': 'x'}]"]


def test_hook_events_are_the_jax_engines(tmp_path, registered):
    """2 epochs of 3 steps with an eval after each: the same events in the
    same order with the same steps, epochs and metric keys from both engines;
    the hooks sorted by priority (RecordHook before IterTimerHook)."""
    from passl_tpu.engine import Engine as JaxEngine

    jax_hooks = registered
    events = {}
    for side, cls, kw in (("jax", JaxEngine, {}), ("port", Engine, {"device": "cpu"})):
        hook_cls = (jax_hooks if side == "jax" else port_hooks).HOOKS.get("RecordHook")
        hook_cls.events = []
        config = cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path / side}",
                                                          *HOOK_RUN])
        e = cls(config, mode="train", **kw)
        assert [type(h).__name__ for h in e.hooks.hooks] == ["RecordHook", "IterTimerHook"]
        assert e.hooks.hooks[0].tag == "x"
        e.train()
        events[side] = list(hook_cls.events)
    assert events["port"] == events["jax"]
    assert events["port"][:2] == [("train_begin",), ("epoch_begin", 1)]
    assert [ev[1] for ev in events["port"] if ev[0] == "iter_end"] == [1, 2, 3, 4, 5, 6]
    assert events["port"].count(("eval_end", "float")) == 2
    assert events["port"][-1] == ("train_end",)
    iter_keys = [ev[2] for ev in events["port"] if ev[0] == "iter_end"][0]
    assert {"loss", "CELoss", "moe_aux_loss", "moe_balance", "lr"} <= set(iter_keys)


def test_an_unknown_hook_raises_as_in_jax(tmp_path):
    from passl_tpu.engine.hooks import build_hooks as jax_build

    with pytest.raises(KeyError):
        jax_build([{"name": "NoSuchHook"}])
    with pytest.raises(KeyError):
        Engine(cfg_util.get_config(TINY_CFG, overrides=[
            f"Global.output_dir={tmp_path}", "Global.hooks=[{'name': 'NoSuchHook'}]"]),
            mode="train", device="cpu")


# --------------------------------------------------------------- profiler

OPTION_STRINGS = [
    None, "", "batch_range=[3,7]", "batch_range=[0, 2]; profile_path=/x/y; exit_on_finished=False",
    "state=GPU;sorted_key=calls;tracer_option=OpDetail;custom=12", "exit_on_finished=0;;",
]


@pytest.mark.parametrize("options", OPTION_STRINGS)
def test_profiler_options_parse_as_jax(options):
    from passl_tpu.utils.profiler import ProfilerOptions as JaxOptions

    assert profiler.ProfilerOptions(options).options == JaxOptions(options).options


@pytest.mark.parametrize("bad", ["batch_range=[5,5]", "batch_range=[-1,2]", "batch_range=3"])
def test_profiler_options_refuse_a_bad_range_as_jax(bad):
    from passl_tpu.utils.profiler import ProfilerOptions as JaxOptions

    for cls in (JaxOptions, profiler.ProfilerOptions):
        with pytest.raises(AssertionError):
            cls(bad)


@pytest.fixture
def fresh_profiler(monkeypatch):
    """The gate's per-process state cleared before and after."""
    monkeypatch.setattr(profiler, "_profiler_options", None)
    monkeypatch.setattr(profiler, "_profiler", None)
    yield
    if profiler._profiler is not None:
        profiler._profiler.stop()


def test_add_profiler_step_writes_a_trace_over_the_range(tmp_path, fresh_profiler):
    """Steps 1-5 with batch_range [2, 4]: the trace starts after step 2 and is
    written at step 4, holding the matrix products of steps 3 and 4 alone."""
    opts = f"batch_range=[2,4];profile_path={tmp_path / 'prof'};exit_on_finished=False"
    a = torch.randn(16, 16)
    written = []
    for step in range(1, 6):
        for _ in range(step):  # step s runs s products
            a = torch.tanh(a @ a)
        path = profiler.add_profiler_step(opts, step)
        written.append(path)
        assert (profiler._profiler is not None) == (step in (2, 3))
    assert written[:3] == [None, None, None] and written[4] is None
    assert written[3] == str(tmp_path / "prof" / "trace_2_4.json")
    events = json.load(open(written[3]))["traceEvents"]
    assert sum(ev.get("name") == "aten::mm" for ev in events) == 3 + 4


def test_add_profiler_step_exits_with_code_0_when_finished(tmp_path, fresh_profiler):
    opts = f"batch_range=[1,2];profile_path={tmp_path}"
    assert profiler.add_profiler_step(None, 1) is None  # no options: nothing
    profiler.add_profiler_step(opts, 1)
    with pytest.raises(SystemExit) as exc:
        profiler.add_profiler_step(opts, 2)
    assert exc.value.code == 0
    assert os.path.exists(tmp_path / "trace_1_2.json")


@pytest.mark.parametrize("finish", ["exit", "continue"])
def test_the_engine_calls_the_profiler_after_each_step(tmp_path, fresh_profiler, finish):
    """Global.profiler_options (the train CLI's -p): the trace of steps 2 and 3
    under profile_path, then with exit_on_finished the run exits with code 0
    at step 3, else it trains on to its end."""
    from passl_tpu_torch.tools import train as train_cli

    opts = (f"batch_range=[1,3];profile_path={tmp_path / 'prof'};"
            f"exit_on_finished={finish == 'exit'}")
    argv = ["-c", TINY_CFG, "--device", "cpu", "-p", opts, "-o", f"Global.output_dir={tmp_path}",
            "-o", "DataLoader.Train.dataset.size=40", "-o", "DataLoader.Train.sampler.batch_size=8",
            "-o", "Global.eval_during_train=False", "-o", "Global.print_batch_step=1"]
    assert train_cli.parse_args("t", argv).profiler_options == opts
    if finish == "exit":
        with pytest.raises(SystemExit) as exc:
            train_cli.main(argv)
        assert exc.value.code == 0
    else:
        e = train_cli.main(argv)
        assert e.state.step == 5
    trace = json.load(open(tmp_path / "prof" / "trace_1_3.json"))
    assert any(ev.get("name") == "aten::mm" for ev in trace["traceEvents"])
