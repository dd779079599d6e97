"""Checkpoint and resume of the port (``train/checkpoint.py`` and
``FullBatchTrainer.fit``'s ``ckpt_dir``/``checkpoint_every``/``resume``),
the counterparts of tests/test_checkpoint.py:30-100: a save/restore round
trip, retention and the best slot, and a run stopped after a checkpoint
and resumed that gives the uninterrupted run's losses, best epoch and
weights exactly (dropout on: the dropout stream must line up too). The
port runs on the CPU."""

import os
import pickle

import numpy as np
import pytest
import torch

from difformer_tpu_torch import DIFFormer, FullBatchTrainer, GraphData
from difformer_tpu_torch.data import (class_rand_splits, random_graph,
                                      standard_preprocess)
from difformer_tpu_torch.train.checkpoint import (CheckpointManager,
                                                  restore_checkpoint,
                                                  save_checkpoint)
import torch_port_helpers  # noqa: F401  (sets torch's threads)

N, C = 120, 3


def _trainer(dropout=0.3):
    x, ei, y = random_graph(N, 500, 8, C, seed=5, homophily=0.8)
    g = GraphData.from_numpy(x, standard_preprocess(ei, N), device="cpu")
    model = DIFFormer(8, 8, C, num_layers=2, dropout=dropout, device="cpu")
    split = class_rand_splits(y, 10, valid_num=30, test_num=40, rng=0)
    return FullBatchTrainer(model, g, y, lr=1e-2, seed=3, device="cpu"), split


def _step(trainer, state, generator):
    mask = torch.arange(N) < 40
    return trainer.train_step(state, generator, mask)


def test_save_restore_roundtrip(tmp_path):
    tr, _ = _trainer()
    state = tr.init_state(0)
    gen = torch.Generator().manual_seed(0)
    state, _ = _step(tr, state, gen)
    path = os.path.join(tmp_path, "ckpt.pt")
    save_checkpoint(path, {"model": state.model.state_dict(),
                           "optimizer": state.optimizer.state_dict(),
                           "generator": gen.get_state(), "step": 1})
    assert os.listdir(tmp_path) == ["ckpt.pt"]  # no temporary file left
    saved = restore_checkpoint(path)
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved["model"][k], v)
    assert saved["step"] == 1
    assert torch.equal(saved["generator"], gen.get_state())
    fresh = tr.init_state(1)
    fresh.optimizer.load_state_dict(saved["optimizer"])
    for p, q in zip(fresh.optimizer.state.values(),
                    state.optimizer.state.values()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(p[key], q[key])


def test_resume_step_by_step(tmp_path):
    """Two steps straight equal one step, a checkpoint, a restore into a
    fresh state and one more step, bit for bit."""
    tr, _ = _trainer()
    state = tr.init_state(0)
    gen = torch.Generator().manual_seed(7)
    for _ in range(2):
        state, _ = _step(tr, state, gen)
    direct = {k: v.clone() for k, v in state.model.state_dict().items()}

    state = tr.init_state(0)
    gen = torch.Generator().manual_seed(7)
    state, _ = _step(tr, state, gen)
    path = os.path.join(tmp_path, "mid.pt")
    save_checkpoint(path, {"model": state.model.state_dict(),
                           "optimizer": state.optimizer.state_dict(),
                           "generator": gen.get_state()})
    saved = restore_checkpoint(path)
    state = tr.init_state(1)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    gen = torch.Generator()
    gen.set_state(saved["generator"])
    state, _ = _step(tr, state, gen)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, direct[k]), k


def test_manager_retention_and_best_slot(tmp_path):
    mgr = CheckpointManager(os.path.join(tmp_path, "run"), max_to_keep=2)
    assert mgr.latest_step() is None
    for step in (2, 5, 8):
        mgr.save(step, {"x": torch.full((2,), float(step))},
                 metrics={"valid": step / 10})
    assert mgr.steps() == [5, 8] and mgr.latest_step() == 8
    saved = mgr.restore(8)
    assert torch.equal(saved["x"], torch.full((2,), 8.0))
    assert saved["metrics"] == {"valid": 0.8}
    assert mgr.save_if_best(0, {"v": 0.5}, 0.5)
    assert not mgr.save_if_best(1, {"v": 0.4}, 0.4)
    assert mgr.save_if_best(2, {"v": 0.9}, 0.9)
    assert mgr.restore_best() == {"v": 0.9}
    mgr.close()
    assert sorted(os.listdir(mgr.directory)) == ["5.pt", "8.pt", "best.pt"]


def test_restore_refuses_arbitrary_objects(tmp_path):
    """Only tensors and plain containers are unpickled."""
    path = os.path.join(tmp_path, "bad.pt")
    torch.save({"f": np.random.default_rng}, path)
    with pytest.raises(pickle.UnpicklingError):
        restore_checkpoint(path)


def test_periodic_checkpoint_and_deterministic_resume(tmp_path):
    """Stopped after 6 of 10 epochs (checkpoints every 3, the latest at
    epoch 5) and resumed: the same losses of every epoch, the same best
    record, and the epoch-8 checkpoint's weights, Adam state and dropout
    generator equal to those of an uninterrupted run."""
    d_full, d_cut = str(tmp_path / "full"), str(tmp_path / "cut")
    tr, split = _trainer()
    full = tr.fit(split, epochs=10, ckpt_dir=d_full, checkpoint_every=3)[0]
    tr, split = _trainer()
    first = tr.fit(split, epochs=6, ckpt_dir=d_cut, checkpoint_every=3)[0]
    assert first["losses"] == full["losses"][:6]
    tr, split = _trainer()
    resumed = tr.fit(split, epochs=10, ckpt_dir=d_cut, checkpoint_every=3,
                     resume=True)[0]
    assert resumed["losses"] == full["losses"]
    for k in ("train", "valid", "test", "epoch"):
        assert resumed[k] == full[k]
    a = CheckpointManager(f"{d_cut}/run0")
    b = CheckpointManager(f"{d_full}/run0")
    assert a.steps() == b.steps() == [2, 5, 8]
    sa, sb = a.restore(8), b.restore(8)
    for k, v in sb["model"].items():
        assert torch.equal(sa["model"][k], v), k
    for p, q in zip(sa["optimizer"]["state"].values(),
                    sb["optimizer"]["state"].values()):
        for key in p:
            assert torch.equal(p[key], q[key])
    assert torch.equal(sa["generator"], sb["generator"])
    assert sa["best"] == sb["best"] and sa["best_valid"] == sb["best_valid"]


def test_resume_without_a_checkpoint_starts_fresh(tmp_path):
    tr, split = _trainer()
    a = tr.fit(split, epochs=4, ckpt_dir=str(tmp_path), checkpoint_every=2,
               resume=True)[0]
    b = tr.fit(split, epochs=4)[0]
    assert a["losses"] == b["losses"] and a["epoch"] == b["epoch"]
