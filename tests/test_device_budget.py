"""What the program takes from the device it runs on: memory limits that
size batches, the compile-cache directory, one card per process, and the
GPU smoke script's refusal to run anywhere else."""
import os
import subprocess
import sys
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "/somewhere/else"])
def test_compilation_cache_dir(env_dir):
    import quilt_tpu

    env = {} if env_dir is None else {"JAX_COMPILATION_CACHE_DIR": env_dir}
    got = quilt_tpu.compilation_cache_dir(env)
    if env_dir is None:
        # one fixed, git-ignored directory at the checkout root
        assert got == os.path.join(REPO, ".jax_cache")
        ignored = subprocess.run(
            ["git", "check-ignore", "-q", os.path.join(got, "x")],
            cwd=REPO,
        )
        assert ignored.returncode == 0
    else:
        assert got is None          # JAX reads the variable; nothing is set


def test_compilation_cache_set_on_import(tmp_path):
    """Importing the package points JAX's cache at the fixed directory,
    or leaves the variable's directory in place when it is set."""
    code = ("import quilt_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == os.path.join(REPO, ".jax_cache")
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == str(tmp_path)


def _fake_device(platform, stats):
    return types.SimpleNamespace(
        platform=platform, device_kind=f"fake {platform}",
        memory_stats=lambda: stats,
    )


def test_device_bytes_limit_sources():
    from quilt_tpu.utils.device import device_bytes_limit

    gpu = _fake_device("gpu", {"bytes_limit": 60 << 30, "bytes_in_use": 0})
    assert device_bytes_limit(gpu) == 60 << 30
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert device_bytes_limit(_fake_device("cpu", None)) == host
    with pytest.raises(RuntimeError, match="no memory limit"):
        device_bytes_limit(_fake_device("gpu", None))
    with pytest.raises(RuntimeError, match="no memory limit"):
        device_bytes_limit(_fake_device("gpu", {"bytes_in_use": 0}))


def test_gibbs_batch_clamp_from_memory_limit():
    """The engine's chain cap scales with the device's memory limit and
    with the per-row footprint of one sweep."""
    from quilt_tpu.engine.batch import GIBBS_MEMORY_SHARE, gibbs_chain_cap

    K_pad, G, R = 640, 512, 1728
    cap_2 = gibbs_chain_cap(K_pad, 2, G, R, 60 << 30)
    per_row = 9 * G * 2 * K_pad * 4 + 5 * K_pad * R * 4
    assert cap_2 == int((60 << 30) * GIBBS_MEMORY_SHARE) // per_row
    # the quick-start batch (32 samples x 7 chains) fits an 80 GB card
    assert cap_2 >= 32 * 7
    assert gibbs_chain_cap(K_pad, 3, G, R, 60 << 30) < cap_2   # NIPT rows
    assert gibbs_chain_cap(K_pad, 2, G, R, 30 << 30) < cap_2
    assert gibbs_chain_cap(K_pad, 2, G, R, 1) == 1


def test_lem_cache_gate_from_memory_limit():
    from quilt_tpu.engine.batch import lem_cache_fits

    # quick-start batch: 32 samples x 5,120 haps fits a 60 GiB limit
    assert lem_cache_fits(32, 5120, 1792, 16384, 60 << 30)
    # the same cache on a 4 GiB device does not
    assert not lem_cache_fits(32, 5120, 1792, 16384, 4 << 30)


@pytest.mark.parametrize("layout", ["one_host_4_cards", "2_hosts_1_card"])
def test_init_multihost_opens_one_card(monkeypatch, layout):
    """A given card pins the process to it; without one the choice is
    JAX's (cluster detection), so a rank never names a card its host
    lacks (rank 1 of 2 one-card hosts must not ask for card 1)."""
    import jax
    from quilt_tpu.dist.hosts import init_multihost

    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda *a, **kw: calls.append((a, kw)))
    if layout == "one_host_4_cards":
        init_multihost("localhost:1234", 4, 2, local_device=2)
        assert calls[0][1]["local_device_ids"] == [2]
        assert calls[0][1]["num_processes"] == 4
        assert calls[0][1]["process_id"] == 2
    else:
        for rank in (0, 1):
            init_multihost("host0:1234", 2, rank)
        assert [c[1]["local_device_ids"] for c in calls] == [None, None]
        assert [c[1]["process_id"] for c in calls] == [0, 1]


def test_read_window_scatter_matches_add_at(rng):
    """Pad bases clip onto window slot 0 and a read may list a SNP twice:
    the windowed rows must equal np.add.at over the same pairs."""
    from quilt_tpu.kernels.emissions import ReadWindowCache

    Bu, R, J, G = 3, 150, 16, 40
    u = np.sort(rng.integers(0, G * 32, (Bu, R, J)), axis=-1).astype(np.int32)
    u[:, :, 1] = u[:, :, 0]
    mask = rng.random((Bu, R, J)) < 0.75
    mask[:, :, :2] = True
    u = np.where(mask, u, 0)
    lpr = np.where(mask, -rng.random((Bu, R, J)), 0).astype(np.float32)
    lpa = np.where(mask, -rng.random((Bu, R, J)), 0).astype(np.float32)
    cache = ReadWindowCache(u, lpr, lpa, mask, G, Rc=64)
    s0 = np.repeat(np.asarray(cache.s0), cache.Rc)[:R]
    loc = np.clip(u - (s0 * 32)[None, :, None], 0, cache.Swin - 1)
    b_i, r_i, _ = np.indices(u.shape)
    for (hi, lo), vals in ((cache.pr, lpr), (cache.pa, lpa)):
        want = np.zeros((Bu, cache.Rpad, cache.Swin))
        np.add.at(want, (b_i, r_i, loc), np.where(mask, vals, 0.0))
        got = np.asarray(hi, np.float32) + np.asarray(lo, np.float32)
        np.testing.assert_allclose(got, want, atol=1e-4)


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding only the script has no program to run."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def _chip_smoke_module():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_four_card_comparison_on_cpu_mesh():
    """The smoke script's mesh comparison on 4 of the CPU test mesh's
    devices, at a small panel whose truth spans every panel shard: the
    sharded FB matches one device within the script's tolerances, and the
    engine on a data mesh meets the truth gate."""
    import jax
    from quilt_tpu.config import ImputeConfig

    assert len(jax.devices()) >= 4
    chip_smoke = _chip_smoke_module()
    prep, samples, labels, truth_g = chip_smoke.biobank_world(
        seed=3, K=512, N=2, nSNPs=1024
    )
    inputs, gl = chip_smoke.mesh_fb_rows(prep, samples, labels, n_rows=4)
    rows = chip_smoke.compare_sharded_fb(inputs, gl, [(1, 4), (4, 1)])
    assert [r["mesh"] for r in rows] == [(1, 4), (4, 1)]
    for row in rows:
        assert row["max_abs_ds_diff"] <= chip_smoke.MESH_DS_TOL
        assert row["max_rel_ll_diff"] <= chip_smoke.MESH_LL_RTOL
    cfg = ImputeConfig(
        nGibbsSamples=2, n_seek_its=2, Ksubset=64, Knew=64, seed=1,
        sample_batch=2, make_plots=False,
        small_ref_panel_gibbs_iterations=8,
    )
    r2_m, _, _ = chip_smoke.mesh_engine_check(
        prep, samples, truth_g, cfg, (4, 1), r2_min=0.8
    )
    assert r2_m >= 0.8


def test_four_card_comparison_catches_lost_shard(monkeypatch):
    """A panel-sharded FB that drops the other shards' mass (its sums over
    K stay local) fails the comparison: the truth haplotypes sit in every
    shard, so no shard alone carries the posterior."""
    import jax

    chip_smoke = _chip_smoke_module()
    prep, samples, labels, _ = chip_smoke.biobank_world(
        seed=3, K=512, N=2, nSNPs=1024
    )
    inputs, gl = chip_smoke.mesh_fb_rows(prep, samples, labels, n_rows=4)
    monkeypatch.setattr(jax.lax, "psum", lambda x, axis_name: x)
    with pytest.raises(chip_smoke.SmokeError, match="off one device"):
        chip_smoke.compare_sharded_fb(inputs, gl, [(1, 4)])
