"""The PyTorch port imports neither jax nor anything of the JAX package.

Checked in a fresh subprocess, because this test process (conftest.py)
has already imported jax."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    pkg = os.path.join(REPO, "parallel_eda_tpu_torch")
    mods = []
    for root, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d not in ("build", "csrc",
                                                "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_imports_no_jax():
    mods = _port_modules()
    assert "parallel_eda_tpu_torch.route.planes" in mods
    assert "parallel_eda_tpu_torch.route.planes_kernels" in mods
    assert "parallel_eda_tpu_torch.place.prng" in mods
    for m in ("__main__", "arch.xml_parser", "pack.pb_pack", "pack.pb_type",
              "netlist.blif", "netlist.files", "netlist.synthesis",
              "netlist.verilog", "route.report", "power", "draw", "viewer",
              "mdclog", "obs", "obs.metrics", "obs.trace", "obs.devprof",
              "obs.runstore", "resil", "resil.faults", "resil.ladder",
              "resil.watchdog", "resil.checkpoint", "resil.journal",
              "obs.slo", "serve", "serve.queue", "serve.batcher",
              "serve.service", "serve.cli", "serve.fused", "serve.library",
              "serve.daemon", "serve.daemon_cli", "serve.fleet",
              "serve.transport", "route.serial_ref", "route.serial_native",
              "route.qor"):
        assert f"parallel_eda_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'parallel_eda_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_placer_imports_no_jax():
    """The annealer, the delay lookup and flow.run_place, imported alone
    and called on the CPU, pull in neither jax nor flax nor the JAX
    package."""
    code = (
        "import sys\n"
        "import parallel_eda_tpu_torch.place.sa\n"
        "import parallel_eda_tpu_torch.place.delay_lookup\n"
        "from parallel_eda_tpu_torch.flow import run_place, synth_flow\n"
        "from parallel_eda_tpu_torch.place.sa import PlacerOpts\n"
        "f = run_place(synth_flow(num_luts=10, num_inputs=3, "
        "num_outputs=3, chan_width=8, seed=1), PlacerOpts(max_temps=2), "
        "device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'parallel_eda_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(f.place_stats.temps))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's own imports (module level) pull in no jax."""
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('cs', "
            "'chip_smoke.py')\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "assert not [k for k in sys.modules if k == 'jax' or "
            "k.startswith('parallel_eda_tpu.')]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_fails_without_card():
    """Without a CUDA device the smoke exits non-zero and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
