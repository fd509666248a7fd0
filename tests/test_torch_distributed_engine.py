"""The port's pod-scale step (`repro_torch.core.distributed_engine`)
against the JAX package's (`repro.core.distributed_engine`): at one rank
against JAX's `make_snn_step` on `make_local_mesh()` and both packages'
`small_reference_step` (the case of tests/test_system.py), and at 4 gloo
ranks (`tests/_torch_mesh_ranks.py pod`, a subprocess) against JAX's
`small_reference_step` on each rank's shard and window, word-aligned
(packed wire) and not (bool wire)."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed_engine as jde
from repro.distributed.context import mesh_context
from repro.launch.mesh import make_local_mesh
from repro_torch.core import distributed_engine as tde
from repro_torch.core import prng

ROOT = Path(__file__).resolve().parents[1]


def test_state_shapes_and_config_match_jax():
    cfg_j, cfg_t = jde.SNNShardConfig(), tde.SNNShardConfig()
    assert cfg_t.n_synapses == cfg_j.n_synapses == 40_000_000_000
    assert cfg_t.window == cfg_j.fan_window_blocks * cfg_j.block == 512
    want = jde.snn_state_shapes(cfg_j, make_local_mesh())
    got = tde.snn_state_shapes(cfg_t, None)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
    # the paper's share at 256 devices: 625,000 a device, not word-aligned
    assert cfg_t.n_neurons // 256 == 625_000 and 625_000 % 32 == 8


@pytest.mark.parametrize("n", [1024, 1000])
def test_one_rank_matches_jax(n):
    """World size 1 == JAX's make_snn_step on the local mesh == both
    packages' small_reference_step, packed (1024) and bool (1000)."""
    cfg_j = jde.SNNShardConfig(n_neurons=n, fan_window_blocks=2)
    cfg_t = tde.SNNShardConfig(n_neurons=n, fan_window_blocks=2)
    W = cfg_t.window
    rng = np.random.default_rng(n)
    g = {"V": rng.integers(-100, 500, n).astype(np.int32),
         "theta": np.full(n, 300, np.int32),
         "lam": np.full(n, 4, np.int32),
         "weights": rng.integers(-30, 50, (W, n)).astype(np.int16),
         "spikes": rng.random(n) < 0.1}
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    tkey = prng.fold_in(prng.PRNGKey(0), 1)
    mesh = make_local_mesh()
    with mesh_context(mesh):
        jout = jde.make_snn_step(cfg_j, mesh)(
            {k: jnp.asarray(v) for k, v in g.items()}, jkey)
    jV, jS = jde.small_reference_step(
        *(jnp.asarray(g[k]) for k in ("V", "theta", "lam", "spikes",
                                      "weights")), jkey)
    np.testing.assert_array_equal(np.asarray(jout["V"]), np.asarray(jV))
    state = {k: torch.as_tensor(v) for k, v in g.items()}
    tout = tde.make_snn_step(cfg_t, None)(state, tkey)
    tV, tS = tde.small_reference_step(
        *(state[k] for k in ("V", "theta", "lam", "spikes", "weights")),
        tkey)
    for V, S in ((tout["V"], tout["spikes"]), (tV, tS)):
        np.testing.assert_array_equal(V.numpy(), np.asarray(jV))
        np.testing.assert_array_equal(S.numpy(), np.asarray(jS))
    assert tS.any() and not tS.all()


def test_four_gloo_ranks_subprocess(tmp_path):
    """4 ranks on a (data 2, model 2) mesh, n_loc 96 (packed) and 90
    (bool), one window clamped at the end: every rank's V and spikes ==
    the JAX package's `small_reference_step` on its shard and its window
    of the global spikes (`spikes_prev[base:]`, base = min(lin * n_loc,
    N - W)), 4 steps, each step's global spikes the ranks' JAX outputs."""
    world, n_locs, steps = 4, (96, 90), 4
    cases = {"n_locs": np.asarray(n_locs)}
    for n_loc in n_locs:
        N, W = world * n_loc, 2 * 64
        rng = np.random.default_rng(n_loc)
        g = {"V": rng.integers(-100, 500, N).astype(np.int32),
             "theta": np.full(N, 300, np.int32),
             "lam": np.full(N, 4, np.int32),
             "weights": rng.integers(-30, 50, (W, N)).astype(np.int16),
             "spikes": rng.random(N) < 0.1}
        cases.update({f"{n_loc}_{k}": v for k, v in g.items()})
        V, glob = jnp.asarray(g["V"]), jnp.asarray(g["spikes"])
        want_V, want_S = [], []
        for s in range(steps):
            key = jax.random.fold_in(jax.random.PRNGKey(0), s)
            outs = []
            for lin in range(world):
                sl = slice(lin * n_loc, (lin + 1) * n_loc)
                base = min(lin * n_loc, N - W)
                outs.append(jde.small_reference_step(
                    V[sl], jnp.asarray(g["theta"][sl]),
                    jnp.asarray(g["lam"][sl]), glob[base:],
                    jnp.asarray(g["weights"][:, sl]), key))
            V = jnp.concatenate([o[0] for o in outs])
            glob = jnp.concatenate([o[1] for o in outs])
            want_V.append(np.asarray(V))
            want_S.append(np.asarray(glob))
        cases[f"{n_loc}_want_V"] = np.stack(want_V)
        cases[f"{n_loc}_want_spikes"] = np.stack(want_S)
        assert cases[f"{n_loc}_want_spikes"].any(axis=1).all()
    np.savez(tmp_path / "pod.npz", **cases)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_mesh_ranks.py"),
         "pod", str(tmp_path / "pod.npz"), str(tmp_path / "store"),
         str(world)],
        capture_output=True, text=True, timeout=240, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    assert "MESH-RANKS-OK" in proc.stdout


def test_example_runs_at_world_size_one(capsys):
    """examples/torch_hiaer_scale_snn.py on the CPU: the pod-scale step's
    10 steps and the mesh tier's run, at world size 1."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_hiaer_scale_snn as ex
    finally:
        sys.path.pop(0)
    assert ex.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("spike rate") == 10 and "mesh tier: 1 device" in out
