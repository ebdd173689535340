"""The port's Engine on the host: when its loader workers fork, that no
prefetch thread outlives a loop, and that a multi-process world is refused
until data parallelism is ported.

The tiny CaiT of configs/classification/cait_tiny_synthetic.yaml on the CPU.
"""
import os
import threading

import pytest
import torch
import torch.distributed as dist

from passl_tpu_torch.data.loader import PREFETCH_THREAD
from passl_tpu_torch.engine import engine as engine_mod
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.utils import cfg_util

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "classification", "cait_tiny_synthetic.yaml")
WORKERS = ["DataLoader.Train.loader={'num_workers': 2, 'prefetch': 2}",
           "DataLoader.Eval.loader={'num_workers': 2, 'prefetch': 2}"]


def _config(tmp_path, *overrides):
    return cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}", *overrides])


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == PREFETCH_THREAD and t.is_alive()]


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_worker_pools_exist_before_the_model_moves(tmp_path, monkeypatch, mode):
    """Every loader's pool is forked before `Module.to` moves the model, so
    on the card no worker is forked from a process that holds CUDA."""
    loaders, seen = [], []
    build = engine_mod.build_dataloader

    def spy_build(*args, **kwargs):
        loaders.append(build(*args, **kwargs))
        return loaders[-1]

    move = torch.nn.Module.to

    def spy_to(module, *args, **kwargs):
        seen.append([loader._pool is not None for loader in loaders])
        return move(module, *args, **kwargs)

    monkeypatch.setattr(engine_mod, "build_dataloader", spy_build)
    monkeypatch.setattr(torch.nn.Module, "to", spy_to)
    e = Engine(_config(tmp_path, *WORKERS), mode=mode, device="cpu")
    try:
        assert len(loaders) == (2 if mode == "train" else 1)
        assert seen and all(flags == [True] * len(loaders) for flags in seen), seen
    finally:
        e.close()


def test_no_prefetch_thread_outlives_a_loop(tmp_path):
    """Two steps of a four-step epoch (an early stop at max_train_step), then
    an eval: each loop joins its loader's prefetch thread when it ends."""
    before = _prefetch_threads()
    e = Engine(_config(tmp_path, *WORKERS, "Global.max_train_step=2",
                       "Global.print_batch_step=1"), mode="train", device="cpu")
    assert len(e.train_dataloader) == 4 and e.train_dataloader.num_workers == 2
    e.train()
    assert e.state.step == 2
    assert _prefetch_threads() == before
    e = Engine(_config(tmp_path, *WORKERS, f"Global.checkpoint={tmp_path}/latest.pt"),
               mode="eval", device="cpu")
    assert e.eval() is not None
    assert _prefetch_threads() == before


def test_closing_a_loader_iterator_joins_its_prefetch_thread(tmp_path):
    e = Engine(_config(tmp_path, *WORKERS), mode="train", device="cpu")
    try:
        before = _prefetch_threads()
        it = iter(e.train_dataloader)
        next(it)
        assert len(_prefetch_threads()) == len(before) + 1
        it.close()
        assert _prefetch_threads() == before
    finally:
        e.close()


@pytest.fixture()
def one_process_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_a_world_of_one_trains(tmp_path, one_process_group):
    e = Engine(_config(tmp_path / "out", "Global.max_train_step=1"), mode="train", device="cpu")
    e.train()
    assert e.state.step == 1


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_a_world_of_two_is_refused(tmp_path, monkeypatch, one_process_group, mode):
    """The loader would give each rank half the batch and nothing would
    reduce the gradients: refused until data parallelism is ported."""
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="reduce gradients"):
        Engine(_config(tmp_path / "out"), mode=mode, device="cpu")
