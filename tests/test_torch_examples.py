"""The port's four TN-KDE examples (``examples/*_torch.py``) against the
reference's (``examples/*.py``), on the CPU.

Each reference example runs in a subprocess through a runner that sets the
x64 shim first (jax 0.9.0 removed ``jax.experimental.enable_x64``, which the
reference's device engines call) and then runs the script unchanged; the
port's runs with ``--device cpu`` beside it. Every printed line is compared
after the times, rates and engine names in it are masked: every other
number — density sums, top lixels, masses, correlations, epochs, cache
hits, window and batch counts, the scan counters, the exactness readings —
must be printed with the same digits. Both scripts must exit 0 (the port's
exits non-zero when its check fails).
"""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("quickstart", "heatmap_kernels", "streaming_kde", "serve_tnkde")
TIMEOUT_S = 240

# the x64 shim, then the example as its own __main__
RUNNER = ("import runpy, sys, jax, jax.experimental; "
          "jax.experimental.enable_x64 = lambda *a, **k: jax.enable_x64(True); "
          "sys.argv = [sys.argv[1]]; runpy.run_path(sys.argv[0], run_name='__main__')")

# (pattern, replacement): what differs by design — wall times, rates and
# the engine's name (``jax/…`` against ``torch/…``)
MASKS = [
    (re.compile(r"\bin \d+\.\d+s\b"), "in <s>"),                    # build seconds
    (re.compile(r"build\+query \d+\.\d+s"), "build+query <s>"),
    (re.compile(r" *\d+\.\d+ req/s"), " <rate> req/s"),        # padded to 6 places
    (re.compile(r"\b(p50|p95)=\d+ms"), r"\1=<ms>"),
    (re.compile(r"engine=\S+?(?=[,)\s]|$)"), "engine=<name>"),
    (re.compile(r"^profiles: default=\S+$"), "profiles: default=<name>"),
]


def _masked(text):
    lines = []
    for line in text.splitlines():
        for pat, rep in MASKS:
            line = pat.sub(rep, line)
        lines.append(line)
    return lines


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (os.path.join(ROOT, "src"),
                                                    env.get("PYTHONPATH")) if p)
    return env


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_example_prints_the_reference_numbers(name):
    ref = subprocess.Popen([sys.executable, "-c", RUNNER, os.path.join("examples", f"{name}.py")],
                           cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        port = subprocess.run([sys.executable, os.path.join("examples", f"{name}_torch.py"),
                               "--device", "cpu"], cwd=ROOT, env=_env(OMP_NUM_THREADS="1"),
                              capture_output=True, text=True, timeout=TIMEOUT_S)
        ref_out, ref_err = ref.communicate(timeout=TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, ref_err[-3000:]
    assert port.returncode == 0, port.stderr[-3000:]
    want, got = _masked(ref_out), _masked(port.stdout)
    assert len(got) == len(want) and len(want) >= 5, (got, want)
    for g, w in zip(got, want):
        assert g == w, (g, w)
    assert any(re.search(r"\d", line) for line in want)


def test_port_examples_import_neither_jax_nor_the_reference():
    for name in EXAMPLES:
        with open(os.path.join(ROOT, "examples", f"{name}_torch.py")) as f:
            src = f.read()
        imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, flags=re.M)
        assert imports and not [m for m in imports if m.split(".")[0] in ("jax", "repro")], \
            (name, imports)
        assert '"--device", default="cuda"' in src, name
