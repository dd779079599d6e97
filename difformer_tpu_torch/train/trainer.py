"""Full-batch training engine (node classification), as
``difformer_tpu/train/trainer.py:FullBatchTrainer``.

Replaces the reference's script loop (``node classification/main.py:104-158``):
seeded runs, a full-graph forward and backward per epoch, an eval every
``eval_step`` epochs with best-validation tracking. The graph stays on the
device for the whole run.

Ported so far: ``init_state``, ``train_step``, ``evaluate``, the per-epoch
``fit`` and ``evaluate_params``, with the NLL loss and accuracy (the only
loss and metric of node classification's DIFFormer-a path). The
epoch-scanned path, checkpointing, ``manireg``, the BCE/MSE losses, the other
metrics and extra model keywords are later work (ROADMAP.md, queue A
item 2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from difformer_tpu_torch.data.graph import GraphData
from difformer_tpu_torch.train.optim import torch_adam
from difformer_tpu_torch.utils.device import resolve_device
from difformer_tpu_torch.utils.metrics import eval_acc
from difformer_tpu_torch.utils.weights import load_params


@dataclasses.dataclass
class TrainState:
    """The model being trained, its optimiser and the step count."""

    model: torch.nn.Module
    optimizer: Optional[torch.optim.Optimizer]
    step: int = 0


def nll_loss(logits, labels, mask):
    """NLLLoss(log_softmax(out)) over the masked nodes (``main.py:126-129``)."""
    logp = F.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels.reshape(-1, 1))[:, 0]
    m = mask.to(logits.dtype)
    return -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)


def idx_to_mask(idx, n):
    mask = np.zeros(n, dtype=bool)
    mask[np.asarray(idx)] = True
    return mask


class FullBatchTrainer:
    """Train a node-level model on one (full) graph.

    ``model(x, senders, receivers, edge_weight, generator=g)`` gives the
    logits; in train mode it draws its dropout masks from ``g``. The graph
    and the model are moved to ``device`` (the GPU unless told otherwise).
    """

    def __init__(self, model, graph: GraphData, labels, *, lr: float = 1e-2,
                 weight_decay: float = 5e-4, seed: int = 123, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.graph = graph.to(self.device)
        self.lr = lr
        self.weight_decay = weight_decay
        self.seed = seed
        labels = np.asarray(labels)
        flat = (labels.reshape(labels.shape[0], -1)[:, 0]
                if labels.ndim > 1 else labels)
        self.labels_train = torch.as_tensor(flat.astype(np.int64),
                                            device=self.device)
        self.labels_eval = labels  # numpy, original layout, for metrics

    # -- state ---------------------------------------------------------------
    def init_state(self, run: int = 0, init_params=None) -> TrainState:
        """Fresh weights drawn from ``seed + run`` (or ``init_params``, a
        flax params tree as the JAX package's trainer takes) and a fresh
        Adam."""
        if init_params is None:
            self.model.reset_parameters(
                torch.Generator().manual_seed(self.seed + run))
        else:
            load_params(self.model, init_params)
        opt = torch_adam(self.model.parameters(), self.lr, self.weight_decay)
        return TrainState(self.model, opt, 0)

    def _forward(self, generator=None):
        g = self.graph
        return self.model(g.node_feat, g.senders, g.receivers, g.edge_weight,
                          node_mask=g.node_mask, edge_mask=g.edge_mask,
                          generator=generator)

    # -- public API ----------------------------------------------------------
    def train_step(self, state: TrainState, generator, train_mask):
        """One forward, backward and Adam update. Returns (state, loss) with
        the loss as a 0-d tensor on the device."""
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        out = self._forward(generator)
        loss = nll_loss(out, self.labels_train, train_mask)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    @torch.no_grad()
    def forward_eval(self, state: TrainState):
        """Eval-mode logits [N, C] on the device."""
        state.model.eval()
        return self._forward()

    def evaluate(self, state: TrainState, split_idx):
        out = self.forward_eval(state).float().cpu().numpy()
        res = {}
        for name, idx in split_idx.items():
            idx = np.asarray(idx)
            res[name] = eval_acc(self.labels_eval[idx], out[idx])
        return res, out

    def fit(self, split_idx, *, epochs: int = 100, runs: int = 1,
            eval_step: int = 1, init_params=None):
        """Per-epoch loop with best-validation selection. One summary dict
        per run: ``train``/``valid``/``test`` at the best epoch, ``epoch``,
        and ``losses``, the training loss of every epoch."""
        n = self.graph.num_nodes
        train_mask = torch.as_tensor(idx_to_mask(split_idx["train"], n),
                                     device=self.device)
        summaries = []
        for run in range(runs):
            state = self.init_state(run, init_params=init_params)
            generator = torch.Generator(self.device).manual_seed(
                1000 + self.seed + run)
            best = {"valid": -np.inf, "test": 0.0, "train": 0.0, "epoch": -1}
            losses = []
            for epoch in range(epochs):
                state, loss = self.train_step(state, generator, train_mask)
                losses.append(float(loss))
                if epoch % eval_step == 0 or epoch == epochs - 1:
                    res, _ = self.evaluate(state, split_idx)
                    if res["valid"] > best["valid"]:
                        best = {**res, "epoch": epoch}
            best["losses"] = losses
            summaries.append(best)
        return summaries

    def evaluate_params(self, params, split_idx):
        """Eval-only path for loaded weights (a flax params tree)."""
        state = self.init_state(0, init_params=params)
        return self.evaluate(state, split_idx)
