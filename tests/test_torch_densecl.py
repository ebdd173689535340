"""DenseCL of the PyTorch port against the JAX package.

On the CPU, at tiny sizes (a basic ResNet with one block a stage, the CIFAR
stem and 2 BatchNorm splits, 16 x 16 images, so a 2 x 2 map: S = 4 cells):
`DenseCLNeck` with and without `num_grid`; the positives matched by backbone
similarity; three train-mode forwards and backwards from a converted init on
JAX's queues (the converter's `ssl` collection, `queue2` included) with the
permutations JAX drew handed to the port: the loss and its two parts,
`acc1`, the query encoder's gradients, both queues, the one pointer (with a
write that JAX's `dynamic_update_slice` clamps to K - N) and both encoders'
statistics; the dense negatives' stop-gradient; no shuffle and no enqueue in
eval; and the slice as a whole: the tiny DenseCL of
configs/densecl/densecl_r18_synthetic.yaml takes each of the JAX engine's
first 3 steps from JAX's state on the JAX loader's batch and permutations;
the learning check's extract step into the probe's model. A census builds
every DenseCL config's model on the meta device. A test marked `cuda`
trains the tiny DenseCL on the card and skips elsewhere.
"""
import copy
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.data import to_device
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models import densecl as port_densecl
from passl_tpu_torch.models.densecl import DenseCL
from passl_tpu_torch.models.necks import DenseCLNeck
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.nn.norm import l2_normalize
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch
from test_torch_mocobyol import _buffers, _force, _port_buffers, _to_f64
from test_torch_moco import (_assert_grads_agree, _handed_permutations, _port_state,
                             _randomize, _recorded_permutations)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "densecl", "densecl_r18_synthetic.yaml")
# f32 against XLA's: the same f32 math summed in another order
F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_openmp_thread():
    """The port's tiny CPU steps on one OpenMP thread, put back after: beside
    the test runner's other workers, OpenMP's barriers over a thread a core
    cost more than the tiny convolutions they split. Through threadpoolctl,
    not `torch.set_num_threads`, which also turns MKL's dynamic threading off
    for the rest of the worker and so moves the rounding of later files'
    products (ROADMAP.md, Queue 3)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # a speed setting only; the card's tests run without it
        yield
        return
    with threadpool_limits(1, user_api="openmp"):
        yield


def _drawn_variables(module, seed: int, *args) -> dict:
    """A flax module's variables as `_randomize` draws them, from their shapes
    alone (`jax.eval_shape`: nothing is compiled or run, as every leaf is
    redrawn; not for a model with a queue, which `_randomize` keeps)."""
    import jax

    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a), *args)
    return _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), seed)


def _tiny_kw(K: int) -> dict:
    return dict(backbone={"name": "ResNet", "block": "basic", "layers": [1, 1, 1, 1],
                          "num_classes": 0, "with_pool": False, "cifar_stem": True,
                          "bn_splits": 2},
                neck={"name": "DenseCLNeck", "hid_channels": 32, "out_channels": 16},
                dim=16, K=K, m=0.99, T=0.2, loss_lambda=0.3)


# ------------------------------------------------------------------ the neck


@pytest.mark.parametrize("num_grid, hw", [(None, 4), (2, 4), (2, 5)],
                         ids=["no-grid", "grid-2-of-4", "grid-2-of-5"])
def test_densecl_neck_matches_jax(num_grid, hw):
    """(g, grid, avg_grid) and the input's gradient through all three, in f32;
    a 5 x 5 map pooled by windows of 2 drops its last row and column, as
    flax's VALID avg_pool does."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.necks import DenseCLNeck as JaxNeck

    rng = np.random.RandomState(3)
    x = rng.randn(3, hw, hw, 24).astype(np.float32)
    jn = JaxNeck(hid_channels=20, out_channels=12, num_grid=num_grid)
    variables = _drawn_variables(jn, 4, x)
    pn = DenseCLNeck(24, 20, 12, num_grid=num_grid)
    pn.load_state_dict(flax_to_torch(variables["params"], pn))
    w = [rng.randn(3, 12), rng.randn(*((3, 4, 12) if num_grid else (3, hw * hw, 12))),
         rng.randn(3, 12)]

    def f(x_):
        outs = jn.apply(variables, x_)
        return sum(jnp.sum(o * jnp.asarray(c, jnp.float32)) for o, c in zip(outs, w)), outs

    (_, want), want_dx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = pn(xt)
    sum(torch.sum(o * torch.from_numpy(c).float()) for o, c in zip(got, w)).backward()
    assert [tuple(o.shape) for o in got] == [tuple(o.shape) for o in want]
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(wv), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=F32_TOL, atol=F32_TOL)


# ------------------------------------------------------------------ DenseCL


def _jax_steps(K: int, steps: int = 3):
    """JAX DenseCL's train-mode steps from one randomized init, on 8 images a
    step: per step the inputs, the permutation drawn, loss parts, acc1,
    gradients and the variables after it; and the init."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.densecl import DenseCL as JaxDenseCL

    rng = np.random.RandomState(7)
    jm = JaxDenseCL(**_tiny_kw(K))
    x0 = jnp.zeros((8, 16, 16, 3))
    variables = jax.device_get(jax.jit(lambda b: jm.init(
        {"params": jax.random.PRNGKey(0), "shuffle": jax.random.PRNGKey(1)}, b))((x0, x0)))
    variables = _randomize(variables, 8)
    params, state = variables["params"], {k: v for k, v in variables.items() if k != "params"}

    @jax.jit
    def step(params, state, x1, x2, key):
        def loss(p):
            out, mut = jm.apply({"params": p, **state}, (x1, x2), train=True,
                                mutable=["batch_stats", "ssl"], rngs={"shuffle": key})
            return out["loss"], (out, mut)

        return jax.value_and_grad(loss, has_aux=True)(params)

    out = []
    with _recorded_permutations() as perms:  # the one trace records every step's draw
        for t in range(steps):
            x1 = rng.randn(8, 16, 16, 3).astype(np.float32)
            x2 = (x1 + 0.5 * rng.randn(8, 16, 16, 3)).astype(np.float32)
            (_, (metrics, mut)), grads = step(params, state, x1, x2, jax.random.PRNGKey(10 + t))
            jax.effects_barrier()
            assert len(perms) == t + 1 and not np.array_equal(perms[t], np.arange(8))
            state = jax.device_get(dict(mut))
            out.append(dict(x=(x1, x2), perm=perms[t], metrics=jax.device_get(metrics),
                            grads=jax.device_get(grads), after={"params": params, **state}))
    return variables, out


@pytest.fixture(scope="module")
def jax_steps():
    return _jax_steps(12)


def test_positives_are_matched_by_backbone_similarity(jax_steps):
    """JAX `densecl.py:82-85`: each query cell's positive is the key cell of
    the largest q_b . k_b, the **backbone** features' cosine, not the neck
    grid's. The similarities first (f32, 1e-5), then the indices exactly: a
    row whose two largest similarities lie within the similarities' tolerance
    is a near tie, where f32 summed in another order may pick the other; the
    test counts such rows (none at this seed) and holds every other row
    exactly."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.densecl import _DenseEncoder as JaxEncoder

    variables, steps = jax_steps
    kw = _tiny_kw(12)
    pm = DenseCL(**kw)
    pm.load_state_dict(_port_state(pm, variables))
    pm.train()
    (x1, x2), perm = steps[0]["x"], steps[0]["perm"]
    inv = np.argsort(perm)
    enc = JaxEncoder(kw["backbone"], kw["neck"], jnp.float32)

    def run(name, x):
        v = {"params": variables["params"][name], "batch_stats": variables["batch_stats"][name]}
        return jax.device_get(enc.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])[0])

    _, want_grid, _, want_qb = run("encoder_q", x1)
    _, want_kgrid, _, want_kb = (o[inv] for o in run("encoder_k", x2[perm]))
    norm = lambda a: np.asarray(l2_normalize(torch.from_numpy(np.asarray(a)), dim=-1))  # noqa: E731
    want_sim = np.einsum("nsc,ntc->nst", norm(want_qb), norm(want_kb))
    want_ind = want_sim.argmax(axis=2)

    with torch.no_grad():
        _, q_grid, _, q_b = copy.deepcopy(pm.encoder_q)(torch.from_numpy(x1))
        _, k_grid, _, k_b = (t[torch.from_numpy(inv)] for t in
                             copy.deepcopy(pm.encoder_k)(torch.from_numpy(x2[perm])))
        q_b, k_b, k_grid = (l2_normalize(t, dim=-1) for t in (q_b, k_b, k_grid))
        sim = torch.einsum("nsc,ntc->nst", q_b, k_b).numpy()
        ind, matched = port_densecl.match_positives(q_b, k_b, k_grid)
    np.testing.assert_allclose(sim, want_sim, rtol=F32_TOL, atol=F32_TOL)
    top2 = np.sort(want_sim, axis=2)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) <= 2 * F32_TOL
    assert near_tie.sum() == 0, f"{near_tie.sum()} near-tie rows"
    np.testing.assert_array_equal(ind.numpy()[~near_tie], want_ind[~near_tie])
    np.testing.assert_array_equal(
        matched.numpy(), np.take_along_axis(np.asarray(k_grid), want_ind[..., None], axis=1))
    # the neck grid's own argmax would pick other cells: the test tells them apart
    grid_ind = np.einsum("nsc,ntc->nst", norm(want_grid), norm(want_kgrid)).argmax(axis=2)
    assert (grid_ind != want_ind).any()


def test_densecl_steps_match_jax_on_its_permutations(jax_steps):
    """Three train-mode forwards and backwards of 8 images from one converted
    init, on the permutation JAX drew each step: the loss (1 - lambda) single +
    lambda dense (`densecl.py:106`) and both parts, acc1 from the global
    logits (`:117`), the query encoder's gradients (the neck's pooled grid
    unused on both sides, `:65`, `:73`), both queues, the one pointer and both
    encoders' statistics. queue2 takes l2(mean over S of the normalized grid
    keys) (`:112`), at the start queue takes: with K = 12 the second write
    starts at ptr 8 and is clamped to K - N = 4 for both queues, and the
    pointer advances once a step (`:91`, `:113-115`)."""
    variables, steps = jax_steps
    kw = _tiny_kw(12)
    pm = DenseCL(**kw)
    pm.load_state_dict(_port_state(pm, variables))
    pm.train()
    ptrs = []
    for t, rec in enumerate(steps):
        x1, x2 = (torch.from_numpy(x) for x in rec["x"])
        for p in pm.parameters():
            p.grad = None
        queues = (pm.queue.clone(), pm.queue2.clone())
        with _handed_permutations([rec["perm"]]) as left:
            got = pm((x1, x2), generator=torch.Generator().manual_seed(0))
        assert not left
        want = rec["metrics"]
        assert set(got) == {"loss", "loss_single", "loss_dense", "acc1"}
        for k in ("loss", "loss_single", "loss_dense"):
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=F32_TOL, err_msg=k)
        assert got["acc1"].item() == float(want["acc1"])
        lam = kw["loss_lambda"]
        torch.testing.assert_close(got["loss"], (1 - lam) * got["loss_single"]
                                   + lam * got["loss_dense"])
        got["loss"].backward()
        want_g = dict(_torch_name(p, a) for p, a in _flatten(rec["grads"]).items())
        for name, p in pm.named_parameters():
            if name.startswith("encoder_k."):  # keys take no gradient
                assert p.grad is None and not np.any(want_g[name]), name
            else:
                _assert_grads_agree(p.grad.numpy(), want_g[name], name)
        want_state = _port_state(pm, rec["after"])
        ptrs.append(int(pm.queue_ptr))
        assert ptrs[-1] == int(want_state["queue_ptr"])
        for key in ("queue", "queue2"):
            np.testing.assert_allclose(pm.state_dict()[key].numpy(), want_state[key].numpy(),
                                       rtol=F32_TOL, atol=F32_TOL, err_msg=key)
        # both queues wrote the same 8 columns
        cols = [torch.nonzero((q != q0).any(dim=0)).flatten().tolist()
                for q, q0 in zip((pm.queue, pm.queue2), queues)]
        assert cols[0] == cols[1] == list(range([0, 4, 4][t], [0, 4, 4][t] + 8))
        for key, v in want_state.items():
            if "running" in key:
                np.testing.assert_allclose(pm.state_dict()[key].numpy(), v.numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=key)
    assert ptrs == [8, 4, 0]


def test_the_dense_negatives_take_no_gradient():
    """JAX `densecl.py:102` stop_gradients the dense negatives' logits: the
    queries' gradient is the positives' alone, (softmax_0 - 1) k_matched / (T N S),
    not the full softmax's (which would add sum_j softmax_j queue2_j)."""
    g = torch.Generator().manual_seed(5)
    q = l2_normalize(torch.randn(2, 3, 8, generator=g, dtype=torch.float64), dim=-1)
    k = l2_normalize(torch.randn(2, 3, 8, generator=g, dtype=torch.float64), dim=-1)
    queue2 = l2_normalize(torch.randn(8, 10, generator=g, dtype=torch.float64), dim=0)
    q.requires_grad_()
    port_densecl.dense_info_nce(q, k, queue2, 0.2).backward()
    with torch.no_grad():
        logits = torch.cat([(q * k).sum(-1).reshape(6, 1), q.reshape(6, 8) @ queue2], 1) / 0.2
        p0 = torch.softmax(logits, dim=1)[:, :1]
        want = ((p0 - 1) * k.reshape(6, 8) / (0.2 * 6)).reshape(2, 3, 8)
    torch.testing.assert_close(q.grad, want, rtol=1e-12, atol=1e-14)
    full = q.detach().clone().requires_grad_()
    logits = torch.cat([(full * k).sum(-1).reshape(6, 1), full.reshape(6, 8) @ queue2], 1) / 0.2
    (-torch.log_softmax(logits, 1)[:, 0].mean()).backward()
    assert (full.grad - want).abs().max() > 1e-3


def test_densecl_eval_neither_shuffles_nor_enqueues():
    m = init_module(DenseCL(**_tiny_kw(12)), torch.Generator().manual_seed(0)).eval()
    m.encoder_k.load_state_dict(m.encoder_q.state_dict())  # as the engine starts it
    queues = m.queue.clone(), m.queue2.clone()
    x = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    with _handed_permutations([]):  # a draw would fail: none is left
        out = m((x, x))
    assert set(out) == {"loss", "loss_single", "loss_dense", "acc1"}
    assert out["acc1"].item() == 1.0 and all(torch.isfinite(v) for v in out.values())
    assert torch.equal(m.queue, queues[0]) and torch.equal(m.queue2, queues[1])
    assert int(m.queue_ptr) == 0
    with pytest.raises(ValueError, match="generator"):
        m.train()((x, x))


def test_densecl_queues_and_hooks():
    a = init_module(DenseCL(**_tiny_kw(12)), torch.Generator().manual_seed(3))
    b = init_module(DenseCL(**_tiny_kw(12)), torch.Generator().manual_seed(3))
    assert torch.equal(a.queue, b.queue) and torch.equal(a.queue2, b.queue2)
    assert not torch.equal(a.queue, a.queue2)
    for q in (a.queue, a.queue2):
        assert q.dtype == torch.float32 and tuple(q.shape) == (16, 12)
        torch.testing.assert_close(q.norm(dim=0), torch.ones(12), rtol=1e-6, atol=1e-6)
    assert a.queue_ptr.dtype == torch.long and int(a.queue_ptr) == 0
    assert a.ema_map() == [("encoder_q", "encoder_k", {"momentum": 0.99})]
    assert a.frozen_patterns() == [r"^encoder_k\."]


# ----------------------------------------------------- the slice as a whole

TINY = [
    "Model.backbone={'name': 'ResNet', 'block': 'basic', 'layers': [1, 1, 1, 1], "
    "'num_classes': 0, 'with_pool': False, 'cifar_stem': True}",
    "Model.neck={'name': 'DenseCLNeck', 'hid_channels': 64, 'out_channels': 32}",
    "Model.K=20",
    "DataLoader.Train.dataset.image_size=16",
    "DataLoader.Train.dataset.transform=[{'TwoViewsTransform': {'base_transform1': ["
    "{'RandomResizedCrop': {'size': 16, 'scale': [0.2, 1.0]}}, "
    "{'ColorJitter': {'brightness': 0.4, 'contrast': 0.4, 'saturation': 0.4, 'hue': 0.4, "
    "'prob': 0.8}}, {'RandomGrayscale': {'p': 0.2}}, "
    "{'SimCLRGaussianBlur': {'sigma': [0.1, 2.0], 'p': 0.5}}, {'RandFlipImage': {'prob': 0.5}}, "
    "{'NormalizeImage': {'scale': 0.00392157, 'mean': [0.485, 0.456, 0.406], "
    "'std': [0.229, 0.224, 0.225]}}]}}]",
    "DataLoader.Train.sampler.batch_size=8",
]
PARITY = [*TINY, "FP16.enable=False"]


def _config(tmp_path, *overrides):
    return cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}", *overrides])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's first 3 loader batches, the permutation each of its 3
    train steps drew, its metrics, and its state (parameters, statistics,
    queues, momentum buffers) before each step and after the last, in the
    port's names and layouts."""
    import jax

    from passl_tpu.engine import Engine as JaxEngine

    tmp = tmp_path_factory.mktemp("jax")
    port = build_model(dict(_config(tmp, *PARITY)["Model"]))

    def port_state(state):
        state = jax.device_get(state)
        return (_port_state(port, {"params": state.params, **state.model_state}),
                _port_buffers(state.opt_state))

    je = JaxEngine(_config(tmp, *PARITY), mode="train")
    je.train_dataloader.set_epoch(1)
    batches = []
    for b in je.train_dataloader:
        batches.append(b)
        if len(batches) == 3:
            break
    metrics, states = [], [port_state(je.state)]
    with _recorded_permutations() as perms:  # the one trace records every step's draw
        for b in batches:
            je.state, m = je.train_step(je.state, je.shard_batch(b))
            jax.effects_barrier()
            metrics.append({k: float(v) for k, v in m.items()})
            states.append(port_state(je.state))
    je.train_dataloader.close()
    assert len(perms) == 3
    return batches, perms, metrics, states


def test_tiny_densecl_steps_along_the_jax_engine(tmp_path, jax_run):
    """Each of the JAX engine's 3 train steps, from JAX's state before it and
    on its permutation: the metrics, and every parameter, statistic, both
    queues, the pointer and every momentum buffer after it, by the rule of
    test_torch_mocobyol.py (each tensor's change within 1e-3 of its norm,
    beside 8 f32 roundings of the tensor and the f32 resolution of the change,
    the port's f32 step from its f64 step, counted for each side)."""
    batches, perms, jax_metrics, states = jax_run
    engines = [Engine(_config(tmp_path / name, *PARITY), mode="train", device="cpu")
               for name in ("f32", "f64")]
    e, e64 = engines
    _to_f64(e64.model)
    eps32 = float(np.finfo(np.float32).eps)
    ptrs = []
    with torch.backends.mkldnn.flags(enabled=False), _handed_permutations(
            [p for p in perms for _ in engines]) as left:
        for t, (b, want) in enumerate(zip(batches, jax_metrics)):
            for x in engines:
                _force(x, states[t], t)
            got = {k: float(v) for k, v in
                   e.train_step(e.state, to_device(e.prepare_batch(b), e.device)).items()}
            got64 = e64.train_step(e64.state, to_device(e64.prepare_batch(b), e64.device))
            assert set(got) == set(want) and {"loss", "loss_single", "loss_dense"} <= set(got)
            for k in ("loss", "loss_single", "loss_dense"):
                f32_res = abs(got[k] - float(got64[k]))
                assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]) + f32_res, (t, k)
            assert got["acc1"] == want["acc1"]
            np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
            before, (after, bufs_after) = states[t][0], states[t + 1]
            final, final64 = e.model.state_dict(), e64.model.state_dict()
            assert set(final) == set(after)
            ptrs.append(int(final["queue_ptr"]))
            assert ptrs[-1] == int(after["queue_ptr"])
            for name, p in final.items():
                if name == "queue_ptr":
                    continue
                d_port, d_jax = p - before[name], after[name] - before[name]
                f32_res = (d_port.double() - (final64[name] - before[name].double())).norm().item()
                tol = 1e-3 * d_jax.norm().item() + 8 * eps32 * p.norm().item() + 1e-8 + 2 * f32_res
                assert (d_port - d_jax).norm().item() <= tol, (t, name)
            bufs, bufs64 = (_buffers(x) for x in engines)
            assert set(bufs) == set(bufs_after)
            assert not any(n.startswith("encoder_k.") for n in bufs_after)  # frozen: no state
            for name, buf in bufs_after.items():
                f32_res = (bufs[name].double() - bufs64[name].double()).norm().item()
                tol = 1e-3 * buf.norm().item() + 1e-8 + 2 * f32_res
                assert (bufs[name] - buf).norm().item() <= tol, (t, name)
    assert not left
    # 3 writes of 8 keys into K = 20: 0, 8, then 16 clamped to 12
    assert ptrs == [8, 16, 4]
    for x in engines:
        x.close()


# ------------------------------------------------------------------ census

CENSUS = sorted(glob.glob(os.path.join(REPO, "configs", "densecl", "*.yaml"))) + [
    os.path.join(REPO, "tests", "e2e", "densecl_structured.yaml")]


@pytest.mark.parametrize("path", CENSUS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_densecl_config_builds(path):
    model_cfg = dict(cfg_util.get_config(path)["Model"])
    with torch.device("meta"):
        model = build_model(model_cfg)
    assert type(model).__name__ == "DenseCL"
    assert model.queue.shape == model.queue2.shape == (model_cfg["dim"], model_cfg["K"])


def test_extract_weights_fills_the_structured_probe(tmp_path):
    """The learning check's extract step: the backbone of
    tests/e2e/densecl_structured.yaml's model under `encoder_q.backbone` fills
    every backbone entry of tests/e2e/probe_structured.yaml's model."""
    from passl_tpu_torch.tools import extract_weights

    structured = os.path.join(REPO, "tests", "e2e", "densecl_structured.yaml")
    model = init_module(build_model(dict(cfg_util.get_config(structured)["Model"])),
                        torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "latest.pt")
    torch.save({"model": model.state_dict(), "step": 0}, ckpt)
    picked = extract_weights.main(["--checkpoint", ckpt, "--prefix", "encoder_q.backbone",
                                   "--rename", "backbone", "--output",
                                   str(tmp_path / "backbone.pt"), "--check-config",
                                   os.path.join(REPO, "tests", "e2e", "probe_structured.yaml")])
    want = model.get_submodule("encoder_q.backbone").state_dict()
    assert set(picked) == {f"backbone.{k}" for k in want}


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_densecl_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(_config(tmp_path, *TINY, "Global.max_train_step=2", "Global.print_batch_step=1"),
               mode="train", device="cuda")
    e.train()
    assert [np.isfinite(h["loss"]) for h in e.train_loop.history] == [True, True]
    assert e.model.queue2.device.type == "cuda" and int(e.model.queue_ptr) == 16
