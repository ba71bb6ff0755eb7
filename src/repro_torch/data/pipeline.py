"""Data pipeline: deterministic synthetic token stream + memmap corpus.

The port's copy of ``repro.data.pipeline``: numpy only, its arrays equal
to the reference's bit for bit.  The launcher moves a batch to the
device as ``torch.int32`` tensors (``Model.input_specs``' dtype).

Per-host input sharding (the multi-pod pattern): each process generates
or reads ONLY its slice of the global batch — ``host_slice`` maps
(process_index, process_count) -> rows.  Determinism is keyed on
(seed, step), so restart-after-failure replays the exact same batch the
lost step would have seen (required for exactly-once semantics with
checkpoint/restart).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    corpus_path: Optional[str] = None   # .bin int32 memmap, else synthetic


def host_slice(global_batch: int, process_index: int,
               process_count: int) -> Tuple[int, int]:
    assert global_batch % process_count == 0
    per = global_batch // process_count
    return process_index * per, per


def synthetic_batch(cfg: DataConfig, step: int, process_index: int = 0,
                    process_count: int = 1) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic tokens (deterministic in (seed, step, host))."""
    start, per = host_slice(cfg.global_batch, process_index, process_count)
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, start]))
    toks = rng.integers(0, cfg.vocab_size, size=(per, cfg.seq_len + 1),
                        dtype=np.int32)
    # make it slightly learnable: every 4th token repeats the previous
    toks[:, 1::4] = toks[:, 0:-1:4]
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def memmap_batch(cfg: DataConfig, step: int, process_index: int = 0,
                 process_count: int = 1) -> Dict[str, np.ndarray]:
    data = np.memmap(cfg.corpus_path, dtype=np.int32, mode="r")
    start, per = host_slice(cfg.global_batch, process_index, process_count)
    n_tokens = data.shape[0]
    window = cfg.seq_len + 1
    out = np.empty((per, window), np.int32)
    for i in range(per):
        # strided deterministic sampling across the corpus
        off = ((step * cfg.global_batch + start + i) * 2654435761) % \
            max(n_tokens - window, 1)
        out[i] = data[off:off + window]
    return {"tokens": out[:, :-1], "targets": out[:, 1:]}


def batches(cfg: DataConfig, start_step: int = 0, process_index: int = 0,
            process_count: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    fn = memmap_batch if cfg.corpus_path else synthetic_batch
    while True:
        yield fn(cfg, step, process_index, process_count)
        step += 1
