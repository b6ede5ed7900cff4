"""Synthetic-token data pipeline with task-based prefetch: the port of
``repro/data/pipeline.py``.

Batch generation runs as tasks on the port's runtime
(:mod:`repro_torch.core.api`), submitted ``prefetch_depth`` steps ahead
of the consumer, so the runtime overlaps data preparation with the
training step on the card — the paper's observation that long compute
tasks hide I/O.  Batches are NumPy arrays, deterministic in (seed, step,
shard) and bit-identical to the reference's for every ``input_mode``:
a restored run re-generates exactly the batches it would have seen.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core import api
from ..models.lm import LMConfig


def synth_batch(cfg: LMConfig, batch: int, seq: int, step: int,
                seed: int = 0, shard: int = 0, n_shards: int = 1) -> Dict:
    """Deterministic synthetic LM batch for (seed, step, shard)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, shard, n_shards]))
    b = batch // n_shards
    out: Dict[str, np.ndarray] = {}
    # a token stream with local structure (markov-ish) so loss can improve
    base = rng.integers(0, cfg.vocab_size, size=(b, 1))
    steps = rng.integers(-3, 4, size=(b, seq))
    tokens = np.abs(base + np.cumsum(steps, axis=1)) % cfg.vocab_size
    tokens = tokens.astype(np.int32)
    if cfg.input_mode == "tokens":
        out["tokens"] = tokens
    elif cfg.input_mode == "embeds":
        out["embeds"] = rng.standard_normal((b, seq, cfg.d_model)).astype(np.float32)
    else:  # prefix_embeds (VLM)
        p = min(cfg.prefix_len, seq // 2)
        out["prefix_embeds"] = rng.standard_normal((b, p, cfg.d_model)).astype(np.float32)
        out["tokens"] = tokens[:, : seq - p]
    targets = np.roll(tokens, -1, axis=1)
    targets[:, -1] = 0
    out["targets"] = targets.astype(np.int32)
    mask = np.ones((b, seq), np.float32)
    mask[:, -1] = 0.0
    if cfg.input_mode == "prefix_embeds":
        p = min(cfg.prefix_len, seq // 2)
        mask[:, :p] = 0.0  # no loss on image-patch positions
    out["loss_mask"] = mask
    return out


class DataPipeline:
    """Prefetching batch source backed by the port's runtime tasks
    (``data_prefetch``); needs a started runtime unless ``use_runtime``
    is false."""

    def __init__(self, cfg: LMConfig, batch: int, seq: int, *, seed: int = 0,
                 prefetch_depth: int = 2, use_runtime: bool = True):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.depth = prefetch_depth
        self.use_runtime = use_runtime
        self._task = (api.task(synth_batch, name="data_prefetch")
                      if use_runtime else None)
        self._pending: Dict[int, object] = {}
        self._next = 0

    def _submit(self, step: int) -> None:
        if step not in self._pending:
            self._pending[step] = self._task(self.cfg, self.batch, self.seq,
                                             step, self.seed)

    def get(self, step: Optional[int] = None) -> Dict:
        step = self._next if step is None else step
        self._next = step + 1
        if not self.use_runtime:
            return synth_batch(self.cfg, self.batch, self.seq, step, self.seed)
        self._submit(step)
        for ahead in range(1, self.depth + 1):
            self._submit(step + ahead)
        fut = self._pending.pop(step)
        return api.wait_on(fut)
