"""Multi-process execution: one process per GPU, on one host or several.

Reference analogue: the fork-per-sample model plus job-array sharding
across nodes (QUILT/R/quilt.R:691-694, example/ligation.Md:24-41). The
design (SURVEY section 2.7): `jax.distributed` connects the processes;
samples are DATA-parallel across processes — each ingests its own BAM
subset host-side and imputes its contiguous sample shard on its own card
— then the VCF aggregates (INFO/EAF/HWE accumulators) reduce across
processes and the per-sample VCF columns gather to every process;
process 0 writes the single merged VCF.

Column gather rides `multihost_utils.process_allgather` (NCCL between
GPUs, gloo on CPU). For cohort sizes where gathered columns would not fit
one host, shard the REGION instead (dist/ligate.py) — the reference makes
the same trade with its per-region job array.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def init_multihost(
    coordinator: str, num_processes: int, process_id: int,
    local_device: int = -1,
) -> None:
    """jax.distributed entry point; call before any other jax use.

    `local_device` >= 0 pins this process to that card of its host. With
    -1 JAX chooses: a cluster it detects (SLURM, Open MPI, ...) assigns
    each process its local card, and otherwise the process opens every
    card it can see. Several processes on one host without a cluster
    manager must each be given their card (here, or with
    CUDA_VISIBLE_DEVICES), or each reserves memory on every card."""
    import jax

    jax.distributed.initialize(
        coordinator, num_processes=num_processes, process_id=process_id,
        local_device_ids=[local_device] if local_device >= 0 else None,
    )


def process_info():
    import jax

    return jax.process_index(), jax.process_count()


def sample_shards(N: int, nproc: int) -> List[np.ndarray]:
    """Contiguous balanced sample shards, one per process."""
    return [np.asarray(s, dtype=int) for s in
            np.array_split(np.arange(N), nproc)]


def reduce_sum_across_hosts(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Elementwise sum of each named array over all processes."""
    from jax.experimental import multihost_utils

    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        g = np.asarray(multihost_utils.process_allgather(v))
        out[k] = g.sum(axis=0).astype(v.dtype) if v.dtype.kind in "iu" \
            else g.sum(axis=0)
    return out


def allgather_columns(
    local_columns: Dict[int, List[str]], N: int,
) -> List[Optional[List[str]]]:
    """Gather per-sample VCF column lists from every process.

    local_columns maps GLOBAL sample index -> list of per-SNP strings.
    Returns the full N-length list (every host gets a copy). Strings are
    ASCII without NUL/newline-in-field, so samples encode as
    index-prefixed NUL-joined byte blobs padded to the global max.
    """
    from jax.experimental import multihost_utils

    blob_parts = []
    for i in sorted(local_columns):
        cells = [
            c if isinstance(c, bytes) else c.encode()
            for c in local_columns[i]
        ]                       # column builders emit bytes since round 5
        blob_parts.append(b"%d\x01" % i + b"\n".join(cells))
    blob = b"\x00".join(blob_parts)
    n = np.array([len(blob)], dtype=np.int64)
    max_n = int(np.asarray(multihost_utils.process_allgather(n)).max())
    padded = np.zeros(max(max_n, 1), dtype=np.uint8)
    if len(blob):
        padded[: len(blob)] = np.frombuffer(blob, dtype=np.uint8)
    lens = np.asarray(multihost_utils.process_allgather(n))[:, 0]
    blobs = np.asarray(multihost_utils.process_allgather(padded))
    out: List[Optional[List[str]]] = [None] * N
    for p in range(blobs.shape[0]):
        raw = blobs[p, : int(lens[p])].tobytes().decode()
        if not raw:
            continue
        for part in raw.split("\x00"):
            idx, col = part.split("\x01", 1)
            out[int(idx)] = col.split("\n")
    return out
