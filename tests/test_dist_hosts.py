"""Multi-host execution: 2 jax.distributed processes produce the same VCF
as a single process (dist/hosts.py; reference analogue: fork-per-sample +
job-array, quilt.R:691-694 + example/ligation.Md).

The subprocesses run the REAL CLI (quilt-tpu impute) on a CPU backend with
gloo collectives; process 0 writes the merged VCF. Scaling overhead is
reported (gather + reduction costs vs the single-process run).
"""
import gzip
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from quilt_tpu.io import simulate_panel
from quilt_tpu.io.simulate import simulate_truth_mosaic
from quilt_tpu.io.bam_writer import BamWriter, write_panel_vcf


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _build_world(tmp_path, rng, n_samples=4, K=60, nSNPs=256):
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs, region_span=120_000)
    ref = np.array(["A"] * nSNPs)
    alt = np.array(["G"] * nSNPs)
    vcf = str(tmp_path / "panel.vcf.gz")
    write_panel_vcf(vcf, "chr20", pos, ref, alt, haps)
    gmap = tmp_path / "map.txt"
    gmap.write_text(
        "position COMBINED_rate.cM.Mb. Genetic_Map.cM.\n"
        + f"{pos[0]} 1.0 0.0\n{pos[-1]} 1.0 {(pos[-1]-pos[0])/1e6:.6f}\n"
    )
    bams = []
    for i in range(n_samples):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2)
        bam = str(tmp_path / f"s{i}.bam")
        with BamWriter(bam, "chr20", int(pos[-1]) + 1000,
                       sample_name=f"SAMP{i}") as w:
            span = pos[-1] - pos[0]
            for r in range(int(1.5 * span / 300)):
                start0 = int(rng.integers(pos[0] - 100, pos[-1]))
                L = 300
                h = int(rng.integers(0, 2))
                seq = []
                for off in range(L):
                    gpos = start0 + 1 + off
                    si = np.searchsorted(pos, gpos)
                    if si < nSNPs and pos[si] == gpos:
                        a = truth[h, si]
                        if rng.random() < 0.003:
                            a = 1 - a
                        seq.append("G" if a else "A")
                    else:
                        seq.append("C")
                w.write_read(f"r{r}", start0, "".join(seq), [25] * L)
        bams.append(bam)
    bamlist = tmp_path / "bamlist.txt"
    bamlist.write_text("\n".join(bams) + "\n")
    return vcf, str(gmap), str(bamlist), pos


def _impute_args(outdir, vcf, gmap, bamlist, pos, extra=()):
    return [
        "impute", f"--outputdir={outdir}", "--chr=chr20",
        f"--regionStart={pos[0]}", f"--regionEnd={pos[-1]}", "--buffer=0",
        f"--bamlist={bamlist}", f"--reference_vcf_file={vcf}",
        f"--genetic_map_file={gmap}", "--nGen=100", "--seed=11",
        "--nGibbsSamples=2", "--n_seek_its=2", "--Ksubset=40", "--Knew=30",
        "--sample_batch=2",
    ] + list(extra)


def _vcf_body(path):
    with gzip.open(path, "rt") as fh:
        return [l for l in fh if not l.startswith("##")]


RUNNER = """
import sys, os
sys.path.insert(0, {repo!r})
from quilt_tpu.cli import main
sys.exit(main({args!r}))
"""


def _spawn(rank, args, port, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    script = tmp_path / f"runner_{rank}.py"
    script.write_text(RUNNER.format(
        repo=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        args=args,
    ))
    return subprocess.Popen(
        [sys.executable, str(script)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )


@pytest.mark.slow
def test_two_processes_match_single(tmp_path, rng):
    vcf, gmap, bamlist, pos = _build_world(tmp_path, rng)
    out1 = tmp_path / "out1"
    t0 = time.time()
    p = _spawn(0, _impute_args(str(out1), vcf, gmap, bamlist, pos), 0,
               tmp_path)
    out_text = p.communicate(timeout=900)[0].decode()
    assert p.returncode == 0, out_text[-4000:]
    t_single = time.time() - t0

    port = _free_port()
    out2 = tmp_path / "out2"
    dist = [
        f"--distributed_nproc=2",
        f"--distributed_coordinator=localhost:{port}",
    ]
    t0 = time.time()
    procs = [
        _spawn(
            r,
            _impute_args(str(out2), vcf, gmap, bamlist, pos,
                         extra=dist + [f"--distributed_rank={r}"]),
            port, tmp_path,
        )
        for r in range(2)
    ]
    outs = [pr.communicate(timeout=900)[0].decode() for pr in procs]
    t_multi = time.time() - t0
    for r, pr in enumerate(procs):
        assert pr.returncode == 0, f"rank {r}:\n{outs[r][-4000:]}"

    region = f"chr20.{pos[0]}.{pos[-1]}"
    v1 = out1 / f"quilt.{region}.vcf.gz"
    v2 = out2 / f"quilt.{region}.vcf.gz"
    assert v1.exists() and v2.exists()
    b1, b2 = _vcf_body(str(v1)), _vcf_body(str(v2))
    assert len(b1) == len(b2)
    for l1, l2 in zip(b1, b2):
        f1, f2 = l1.rstrip("\n").split("\t"), l2.rstrip("\n").split("\t")
        # sample columns must be BIT-identical (each sample is imputed by
        # exactly one process with the same global seed)
        assert f1[:7] == f2[:7] and f1[8:] == f2[8:], (l1, l2)
        # INFO aggregates: the cross-host reduction reassociates the
        # per-sample float sums -> tolerate summation-order ulps
        if f1[7] != f2[7]:
            for kv1, kv2 in zip(f1[7].split(";"), f2[7].split(";")):
                k1, v1s = kv1.split("=")
                k2, v2s = kv2.split("=")
                assert k1 == k2
                d = abs(float(v1s) - float(v2s))
                assert d < 1e-3 * max(1.0, abs(float(v1s))), (kv1, kv2)
    # scaling report: cross-process gather/reduce overhead vs single process (wall
    # clock; informational — compile caches dominate at toy scale)
    print(f"single-process: {t_single:.1f}s  2-process: {t_multi:.1f}s  "
          f"overhead ratio {t_multi / max(t_single, 1e-9):.2f}")
