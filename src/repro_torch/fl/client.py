"""FL client trainers.

A *Trainer* binds a model family to the FL loop:
    init_params(seed)                          -> params
    local_train(params, client_id, rnd_seed)   -> (new_params, n_samples)
    evaluate(params)                           -> accuracy in [0,1]

``CNNTrainer`` reproduces the paper's workloads (CNN / ResNet8, real SGD
on real batches).  ``LMTrainer`` makes an LM architecture (dense,
hybrid, MoE or xLSTM) an FL workload (reduced config by default) -- its
"accuracy" is next-token top-1 on a held-out batch, which drives Eq. 3
tier movement exactly like test accuracy does for CNNs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device, set_full_f32
from repro_torch.config.base import FLConfig, ModelConfig
from repro_torch.data.partition import primary_class_partition
from repro_torch.data.pipeline import ClientDataset, client_batches
from repro_torch.data.synthetic import make_image_dataset, make_token_dataset
from repro_torch.launch.steps import (loss_and_grads, ready_checkpoint,
                                      update_in_place)
from repro_torch.models.cnn import cnn_forward, cnn_loss, init_cnn
from repro_torch.models.transformer import forward as lm_forward
from repro_torch.models.transformer import init_model, lm_loss
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_flatten, tree_map, tree_stack, tree_unflatten


class CNNTrainer:
    def __init__(self, cfg: ModelConfig, fl: FLConfig, dataset: str,
                 scale: float = 0.05, device=None):
        self.device = resolve_device(device)
        set_full_f32()
        self.cfg = cfg
        self.fl = fl
        data = make_image_dataset(dataset, seed=fl.seed, scale=scale)
        parts = primary_class_partition(
            data["y_train"], fl.n_clients, fl.primary_frac, seed=fl.seed)
        self.clients: List[ClientDataset] = [
            ClientDataset(data["x_train"][p], data["y_train"][p])
            for p in parts]
        self.x_test = torch.from_numpy(data["x_test"]).to(self.device)
        self.y_test = torch.from_numpy(data["y_test"]).long().to(self.device)
        self.opt = make_optimizer(fl.optimizer)

    def _to_device(self, x: np.ndarray, y: np.ndarray):
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(y).long().to(self.device))

    def _step_impl(self, params, opt_state, x, y, im2col: bool = False):
        """One optimizer step.  Under a leading client axis (stacked
        ``params``, ``im2col=True``) the per-client losses are summed
        before the one autograd call: clients share no parameter, so
        each gets exactly its own gradient."""
        leaves, treedef = tree_flatten(params)
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        p_in = tree_unflatten(treedef, leaves)
        loss = cnn_loss(self.cfg, p_in, {"x": x, "y": y}, im2col=im2col)
        grads = tree_unflatten(
            treedef, torch.autograd.grad(loss.sum(), leaves))
        with torch.no_grad():
            params = tree_map(lambda l: l.detach(), p_in)
            ups, opt_state = self.opt.update(grads, opt_state, params,
                                             self.fl.lr)
            params = tree_map(lambda p, u: (p.float() + u).to(p.dtype),
                              params, ups)
        return params, opt_state, loss.detach()

    def init_params(self, seed: int = 0):
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        return init_cnn(self.cfg, gen, device=self.device)

    def local_train(self, params, client_id: int, rnd_seed: int):
        ds = self.clients[client_id]
        opt_state = self.opt.init(params)
        for ep in range(self.fl.local_epochs):
            for x, y in client_batches(ds, self.fl.batch_size,
                                       rnd_seed * 131 + ep):
                params, opt_state, _ = self._step_impl(
                    params, opt_state, *self._to_device(x, y))
        return params, len(ds)

    # -- batched multi-client path (engine hot path) --------------------
    def _client_epoch_batches(self, client_id: int, rnd_seed: int):
        """All local-training batches for one client, identical stream to
        the looped ``local_train`` (same seeds, same order)."""
        ds = self.clients[client_id]
        xs, ys = [], []
        for ep in range(self.fl.local_epochs):
            for x, y in client_batches(ds, self.fl.batch_size,
                                       rnd_seed * 131 + ep):
                xs.append(x)
                ys.append(y)
        return np.stack(xs), np.stack(ys)          # (T, B, ...), (T, B)

    def _batch_train_multi_impl(self, start_params, xs, ys):
        """xs (C, T, B, H, W, ch), ys (C, T, B), ``start_params``
        stacked (C, ...) -> stacked params (C, ...).

        One batched program over the client axis: every local step is
        one forward, one backward and one optimizer update for the
        whole cohort; the local-step loop is a Python loop.  im2col
        keeps the per-client conv kernels on the batched-GEMM path.
        """
        params = start_params
        opt_state = self.opt.init(params)
        for t in range(xs.shape[1]):
            params, opt_state, _ = self._step_impl(
                params, opt_state, xs[:, t], ys[:, t], im2col=True)
        return params

    def _batch_train_impl(self, params, xs, ys):
        """Every client starts from the same ``params``: give each its
        own copy along a new leading axis, then train them together."""
        n = xs.shape[0]
        starts = tree_map(
            lambda l: l.unsqueeze(0).expand(n, *l.shape).contiguous(),
            params)
        return self._batch_train_multi_impl(starts, xs, ys)

    def _bucketed_train(self, keys, train_chunk):
        """Shared shape-bucketing for the batched paths: build each
        (client, seed)-keyed batch stream once, bucket positions by
        stream shape (ragged partitions), run ``train_chunk(xs, ys,
        positions)`` per bucket, and reassemble chunk rows in input
        order."""
        data = {}                     # pad slots repeat (client, seed)
        buckets: Dict[tuple, List[int]] = {}
        for pos, key in enumerate(keys):
            if key not in data:       # keys, so compute each stream once
                data[key] = self._client_epoch_batches(*key)
            buckets.setdefault(data[key][0].shape, []).append(pos)
        chunks, order = [], []
        for positions in buckets.values():
            xs, ys = self._to_device(
                np.stack([data[keys[p]][0] for p in positions]),
                np.stack([data[keys[p]][1] for p in positions]))
            chunks.append(train_chunk(xs, ys, positions))
            order.extend(positions)
        if len(chunks) == 1:          # common case: one shape bucket,
            return chunks[0]          # order already the input order
        inv = torch.from_numpy(np.argsort(np.asarray(order))).to(self.device)
        return tree_map(lambda *leaves: torch.cat(leaves, dim=0)[inv],
                        *chunks)

    def local_train_batch(self, params, client_ids, rnd_seed: int, *,
                          wrap=None):
        """Train many clients in one batched program.

        Clients whose local batch streams have differing shapes (ragged
        partitions) are bucketed by shape; each bucket is one call.
        Returns (stacked_params with leading axis len(client_ids) in
        input order, sizes array).

        ``wrap`` is the distributed engine's hook: it receives the
        stacked-train function plus the number of leading replicated
        args and returns the runner to use (the client-sharded path).
        """
        sizes = np.asarray([len(self.clients[c]) for c in client_ids],
                           np.float32)
        run = (self._batch_train_impl if wrap is None
               else wrap(self._batch_train_impl, 1))
        stacked = self._bucketed_train(
            [(c, rnd_seed) for c in client_ids],
            lambda xs, ys, positions: run(params, xs, ys))
        return stacked, sizes

    def local_train_cohort(self, start_params, client_ids, rnd_seeds, *,
                           wrap=None):
        """Per-client start models AND per-client data-stream seeds, one
        batched program.

        ``start_params`` is a stacked tree (leading axis
        len(client_ids)) of the model snapshot each client trains from;
        batch streams are identical to looping
        ``local_train(start_i, c_i, seed_i)``.  ``wrap``: see
        ``local_train_batch`` (every arg is per-client here, so zero
        replicated args).
        """
        sizes = np.asarray([len(self.clients[c]) for c in client_ids],
                           np.float32)
        run = (self._batch_train_multi_impl if wrap is None
               else wrap(self._batch_train_multi_impl, 0))

        def chunk(xs, ys, positions):
            idx = torch.as_tensor(positions, device=self.device)
            starts = tree_map(lambda l: l[idx], start_params)
            return run(starts, xs, ys)

        stacked = self._bucketed_train(list(zip(client_ids, rnd_seeds)),
                                       chunk)
        return stacked, sizes

    def evaluate(self, params, max_samples: int = 2048) -> float:
        n = min(max_samples, self.x_test.shape[0])
        accs = []
        with torch.no_grad():
            for i in range(0, n, 512):
                logits = cnn_forward(self.cfg, params, self.x_test[i:i + 512])
                hit = logits.argmax(-1) == self.y_test[i:i + 512]
                accs.append(hit.float().mean())
            # one readback for the whole evaluation
            return float(np.mean(torch.stack(accs).cpu().numpy()
                                 .astype(np.float64)))


class LMTrainer:
    """FL over a (reduced) LM architecture.

    The reference's jitted, client-``vmap``ped programs become one
    client at a time: a client's local step is a whole-model forward
    and backward, so ``local_train_batch`` and ``local_train_cohort``
    loop over the clients and stack their models, and are the looped
    ``local_train`` bit for bit.  Each client trains a copy of its start
    model in place (``launch.steps.update_in_place``)."""

    def __init__(self, cfg: ModelConfig, fl: FLConfig, seq_len: int = 128,
                 batch: int = 8, corpus_tokens: int = 200_000,
                 step_fn=None, init_fn=None, device=None):
        self.device = resolve_device(device)
        set_full_f32()
        ready_checkpoint()
        self.cfg = cfg
        self.fl = fl
        self.seq = seq_len
        self.batch = batch
        toks = make_token_dataset(cfg.vocab_size, corpus_tokens, seed=fl.seed)
        splits = np.array_split(toks[:-corpus_tokens // 10], fl.n_clients)
        self.client_toks = splits
        self.test_toks = toks[-corpus_tokens // 10:]
        self.opt = make_optimizer(fl.optimizer)
        self._custom_step = step_fn is not None
        self._step = step_fn or self._step_impl
        self._init_fn = init_fn

    def _step_impl(self, params, opt_state, tokens):
        """One optimizer step of ``lm_loss`` (no clip), ``params`` and
        ``opt_state`` updated in place."""
        loss, _, grads = loss_and_grads(
            lambda p: lm_loss(self.cfg, p, {"tokens": tokens}), params)
        with torch.no_grad():
            params, opt_state = update_in_place(self.opt, params, opt_state,
                                                grads, self.fl.lr)
        return params, opt_state, loss

    def _batch(self, toks: np.ndarray, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        n = max(len(toks) - self.seq - 1, 1)
        starts = rng.integers(0, n, self.batch)
        return np.stack([toks[s:s + self.seq] for s in starts])

    def _tokens(self, toks: np.ndarray, seed: int):
        return torch.from_numpy(self._batch(toks, seed)).to(self.device)

    def init_params(self, seed: int = 0):
        if self._init_fn is not None:
            return self._init_fn(seed)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return init_model(self.cfg, gen)

    def local_train(self, params, client_id: int, rnd_seed: int):
        toks = self.client_toks[client_id]
        params = tree_map(lambda l: l.detach().clone(), params)
        opt_state = self.opt.init(params)
        for ep in range(self.fl.local_epochs):
            params, opt_state, _ = self._step(
                params, opt_state, self._tokens(toks, rnd_seed * 131 + ep))
        return params, len(toks)

    def local_train_batch(self, params, client_ids, rnd_seed: int, *,
                          wrap=None):
        """Every client from ``params``: the looped ``local_train`` per
        distinct client (the engine's pow2 padding repeats the last one,
        which trains once), models stacked (leading axis
        len(client_ids)).  ``wrap`` is the distributed engine's hook
        (see ``CNNTrainer``)."""
        self._batchable(wrap)
        trained = {}
        for c in client_ids:
            if c not in trained:
                trained[c] = self.local_train(params, c, rnd_seed)[0]
        return (tree_stack([trained[c] for c in client_ids]),
                self._sizes(client_ids))

    def _batchable(self, wrap) -> None:
        if self._custom_step:
            raise NotImplementedError(
                "custom step_fn trainers use the looped path")
        if wrap is not None:
            raise NotImplementedError(
                "LMTrainer on a client mesh waits for the LM mesh slice")

    def _sizes(self, client_ids):
        return np.asarray([len(self.client_toks[c]) for c in client_ids],
                          np.float32)

    def local_train_cohort(self, start_params, client_ids, rnd_seeds, *,
                           wrap=None):
        """Async-window cohort: per-client start models (stacked) and
        per-client seeds; the looped ``local_train(start_i, c_i,
        seed_i)`` per client, models stacked."""
        self._batchable(wrap)
        models = [self.local_train(tree_map(lambda l: l[i], start_params),
                                   c, s)[0]
                  for i, (c, s) in enumerate(zip(client_ids, rnd_seeds))]
        return tree_stack(models), self._sizes(client_ids)

    def evaluate(self, params) -> float:
        b = self._tokens(self.test_toks, 1234)
        with torch.no_grad():
            logits, _ = lm_forward(self.cfg, params, {"tokens": b})
            pred = torch.argmax(logits[:, :-1], dim=-1)
            return float((pred == b[:, 1:]).float().mean())


def build_fl_clients(arch_id: str, fl: FLConfig,
                     dataset: Optional[str] = None, scale: float = 0.05,
                     reduced: bool = True, device=None):
    """Factory: any registered CNN or LM (dense, hybrid, MoE, xLSTM) arch
    becomes an FL workload; an LM in its reduced config unless
    ``reduced=False``."""
    from repro_torch.config import get_arch
    cfg = get_arch(arch_id)
    if cfg.family == "cnn":
        ds = dataset or {"cnn-mnist": "mnist", "cnn-fmnist": "fmnist",
                         "resnet8-cifar10": "cifar10"}[arch_id]
        return CNNTrainer(cfg, fl, ds, scale=scale, device=device)
    if reduced:
        cfg = cfg.reduced()
    return LMTrainer(cfg, fl, device=device)
