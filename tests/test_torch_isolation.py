"""The port stands alone: `repro_torch` imports neither jax nor anything
of the JAX package `repro`, its entry points run on the card unless the
caller asks for the CPU, and `chip_smoke.py` refuses to report without
a card or without the repository beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def port_modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield p, ".".join(parts)


def test_importing_every_module_loads_no_jax_and_no_repro():
    names = [m for _, m in port_modules()]
    code = ("import sys\n"
            f"for m in {names!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(len(sys.modules), bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(names) >= 30
    assert {"repro_torch.core.hiaer", "repro_torch.kernels.exchange",
            "repro_torch.data.synthetic", "repro_torch.core.convert",
            "repro_torch.core.spiking", "repro_torch.core.rl",
            "repro_torch.core.learning", "repro_torch.core.mesh_runtime",
            "repro_torch.core.distributed_engine",
            "repro_torch.distributed.mesh", "repro_torch.models.ssm",
            "repro_torch.models.rglru"} <= set(names)


def test_no_source_imports_jax_or_repro():
    for path, _ in port_modules():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), \
                    f"{path}:{node.lineno} imports {m}"


def test_portal_front_end_and_faults_load_no_torch_numpy_or_jax():
    """The modules a bridge worker imports — the portal's stdlib half,
    its `--worker` entry point, `obs` and `faults` — load neither torch
    nor numpy (nor jax): the lazy exports keep the package light."""
    mods = ["repro_torch.portal.errors", "repro_torch.portal.auth",
            "repro_torch.portal.ws", "repro_torch.portal.http",
            "repro_torch.portal.bridge", "repro_torch.portal.__main__",
            "repro_torch.faults", "repro_torch.obs"]
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "import repro_torch.portal as p\n"
            "assert 'torch' not in sys.modules\n"
            "p.Portal\n"
            "assert 'torch' in sys.modules\n"
            "print('LIGHT')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LIGHT" in out.stdout


def test_portal_workers_are_spawned_from_the_port():
    """`Portal(workers=2)` spawns `python -m repro_torch.portal --worker`
    (never JAX's `repro.portal`, whose workers would answer as well),
    with the port's src root first on PYTHONPATH, and the running
    workers have loaded no torch library."""
    import numpy as np
    from repro_torch import LIF_neuron, NetworkSpec, compile_spec
    from repro_torch.portal import Portal
    from repro_torch.serve import SpikeServer
    spec = NetworkSpec()
    ax = spec.add_axons(2)
    spec.add_neurons(3, LIF_neuron(threshold=5))
    spec.connect(np.repeat(ax, 3), np.tile(np.arange(3), 2),
                 np.full(6, 3))
    spec.set_outputs([0])
    srv = SpikeServer(max_batch=2, max_wait_ms=1.0)
    srv.add_model("m", compile_spec(spec), window=2, n_sessions=1,
                  device="cpu")
    with srv, Portal(srv, port=0, workers=2) as portal:
        cmd = portal._worker_cmd
        assert cmd[1:4] == ["-m", "repro_torch.portal", "--worker"], cmd
        assert "repro.portal" not in cmd
        assert portal._worker_env["PYTHONPATH"].split(os.pathsep)[0] == \
            str(ROOT / "src")
        for p in portal._procs:
            assert p.args == cmd
            maps = Path(f"/proc/{p.pid}/maps")
            if maps.exists():
                text = maps.read_text()
                assert "libtorch" not in text and "libc10" not in text


def test_deploy_defaults_to_the_card():
    from repro_torch import compile_spec, deploy, LIF_neuron, NetworkSpec
    spec = NetworkSpec()
    ax = spec.add_axons(1)
    spec.add_neurons(1, LIF_neuron(threshold=5))
    spec.connect(ax, [0], [7])
    spec.set_outputs([0])
    c = compile_spec(spec)
    if torch.cuda.is_available():
        assert deploy(c).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            deploy(c)
    dep = deploy(c, device="cpu")
    dep.step([0, 0])
    assert dep.read_membrane([0]) == [14]
    # the hiaer target's deployment, and its tables, follow the same rule
    from repro_torch import Hierarchy
    h = compile_spec(spec, target="hiaer", hierarchy=Hierarchy(1, 1, 2, 1))
    if torch.cuda.is_available():
        assert deploy(h).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            deploy(h)
    dep = deploy(h, device="cpu")
    assert dep.impl.tables.entry_w.device.type == "cpu"
    dep.step([0, 0])
    assert dep.read_membrane([0]) == [14]


def test_simulator_and_facade_default_to_the_card():
    from repro_torch import CRI_network, LIF_neuron, NetworkSpec
    from repro_torch import compile_spec, deploy
    spec = NetworkSpec()
    ax = spec.add_axons(1)
    spec.add_neurons(1, LIF_neuron(threshold=50))
    spec.connect(ax, [0], [7])
    spec.set_outputs([0])
    c = compile_spec(spec, target="simulator")
    if torch.cuda.is_available():
        assert deploy(c).device.type == "cuda"
        assert CRI_network.from_spec(spec, backend="simulator") \
            ._dep.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            deploy(c)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            CRI_network.from_spec(spec, backend="simulator")
    dep = deploy(c, device="cpu")
    dep.step([0, 0])
    assert dep.read_membrane([0]) == [14]
    net = CRI_network.from_spec(spec, backend="simulator", device="cpu")
    net.step([0])
    assert net.read_membrane(0) == [7]


def test_lm_entry_points_default_to_the_card():
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import Server
    from repro_torch.models import lm
    cfg = get_reduced("qwen2_5_3b")
    if torch.cuda.is_available():
        assert lm.init_params(cfg).embed.table.device.type == "cuda"
        assert Server(cfg, max_len=8, slots=1).device.type == "cuda"
    else:
        for make in (lambda: lm.init_params(cfg),
                     lambda: lm.init_cache(cfg, 1, 4),
                     lambda: Server(cfg, max_len=8, slots=1)):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                make()
    srv = Server(cfg, max_len=8, slots=1, device="cpu")
    assert srv.params.embed.table.device.type == "cpu"
    srv.admit([1, 2])
    srv.tick()
    assert len(srv.outputs[0]) == 1


def test_training_entry_points_default_to_the_card():
    from repro_torch.configs import get_reduced
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig
    cfg, oc = get_reduced("qwen2_5_3b"), AdamWConfig()
    argv = ["--arch", "qwen2_5_3b", "--reduced", "--steps", "1",
            "--batch", "1", "--seq", "8"]
    if torch.cuda.is_available():
        assert train.main(argv) > 0
    else:
        for run in (lambda: make_train_step(cfg, oc),
                    lambda: train.main(argv)):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                run()
    assert train.main(argv + ["--device", "cpu"]) > 0


def test_table2_entry_points_default_to_the_card():
    """Training and conversion (`train_qat`, `train_spiking`,
    `train_dqn`, `to_network`, `spiking_to_network`, `params_from_jax`)
    build on the card unless asked for the CPU."""
    import numpy as np
    from repro_torch.core import convert, rl, spiking
    model = convert.QATModel((1, 4, 4), [convert.LayerSpec(
        "dense", out_features=3)], n_classes=2)
    smodel = spiking.SpikingModel((1, 4, 4), [convert.LayerSpec(
        "dense", out_features=3)], n_classes=2)
    X = np.ones((4, 1, 4, 4), np.float32)
    y = np.zeros((4,), np.int64)
    qp, _ = convert.quantize(model.init(torch.Generator().manual_seed(0),
                                        device="cpu"))
    calls = [
        lambda: convert.train_qat(model, X, y, epochs=1, batch=4),
        lambda: spiking.train_spiking(smodel, X[:, None], y, epochs=1,
                                      batch=4),
        lambda: rl.train_dqn(rl.CatchEnv(W=3, H=3), episodes=1),
        lambda: convert.to_network(model, qp),
        lambda: spiking.spiking_to_network(smodel, qp),
        lambda: convert.params_from_jax([{"w": np.ones((2, 2)),
                                          "b": np.ones(2)}])]
    if torch.cuda.is_available():
        net, _ = convert.to_network(model, qp)
        assert net._dep.device.type == "cuda"
    else:
        for make in calls:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                make()
    net, keys = convert.to_network(model, qp, device="cpu")
    assert net._dep.device.type == "cpu"
    pred, pots = convert.infer_image(net, X[0], model, keys)
    assert pots == convert.apply_quantized(model, qp, X[:1])[0].tolist()


def test_mesh_entry_points_default_to_the_card():
    """The mesh target's deployment, the facade's mesh backend and the
    rank's device resolve to the card unless asked for the CPU."""
    from repro_torch import CRI_network, Hierarchy, LIF_neuron, NetworkSpec
    from repro_torch import compile_spec, deploy
    from repro_torch.distributed import mesh
    spec = NetworkSpec()
    ax = spec.add_axons(1)
    spec.add_neurons(2, LIF_neuron(threshold=5))
    spec.connect(ax, [0], [7])
    spec.set_outputs([0])
    kw = dict(hierarchy=Hierarchy(1, 1, 2, 1))
    c = compile_spec(spec, target="mesh", **kw)
    calls = [lambda: deploy(c),
             lambda: CRI_network.from_spec(spec, backend="mesh", **kw)]
    if torch.cuda.is_available():
        assert mesh.rank_device(None).type == "cuda"
        assert deploy(c).device.type == "cuda"
    else:
        for make in calls + [lambda: mesh.rank_device(None)]:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                make()
    assert mesh.rank_device("cpu").type == "cpu"
    dep = deploy(c, device="cpu")
    assert dep.impl.tables.entry_w.device.type == "cpu"
    dep.step([0, 0])
    assert dep.read_membrane([0, 1]) == [14, 0]


def run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_without_a_card_reports_nothing():
    if torch.cuda.is_available():
        return                      # the card run is the script's own job
    out = run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
