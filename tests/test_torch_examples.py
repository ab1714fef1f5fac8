"""The port's example scripts (``examples/torch/``) against the
reference's (``examples/``), on the CPU.

Each reference script runs once a module (``runpy`` with ``sys.argv``
patched and stdout captured; ``examples/quickstart.py`` runs at import,
so ``runpy`` is the only way in), and the port's through ``main([...,
"--device", "cpu"])`` with the same flags.  The printed text is held
line for line: the text between numbers exactly, every integer exactly,
every float within the parity pair (tests/conftest.py) plus half a unit
of its printed last digit.  ``serve_quickstart`` and ``rff_quickstart``
assert their own contracts inline (the serving protocol view bitwise
``engine.run``'s; every RFF sync the same bytes), so their exit code is
part of the check.

The random Fourier features: the reference draws ``RFFSpec(seed=0)``'s
(W, b) with JAX's threefry generator, and the port's spec without
arrays draws the same bits with its own threefry (``repro_torch.prng``,
src/repro_torch/core/rff.py).  The port's scripts run here twice: with
their ``RFFSpec`` handing in the reference's own draw for the same
arguments (``reference_rff_spec``, ``convert.rff_spec``), and with their
own ``RFFSpec(seed)`` (``RFF_SCRIPTS``); both print the reference's
lines.

The flag-less scripts run at their fixed sizes; ``async_susy``,
``susy_distributed`` and ``stock_nowcast`` at the reduced ``--rounds`` /
``--learners`` of ``SCRIPTS``, the same on both sides.  In
``async_susy`` the ``sim-wall``, ``barrier`` and ``speedup`` columns are
the seeded event clock's, so they are compared too.
"""
import contextlib
import importlib.util
import io
import re
import runpy
import sys
from pathlib import Path

import pytest
import torch

from conftest import PARITY_ATOL, PARITY_RTOL
from repro.core import rff as jrff

from repro_torch import convert

ROOT = Path(__file__).resolve().parent.parent

NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
INTEGER = re.compile(r"[-+]?\d+")

#: script name -> the flags both sides take (the reference's own flags)
SCRIPTS = {
    "quickstart": (),
    "rff_quickstart": (),
    "serve_quickstart": (),
    "async_susy": ("--rounds", "100"),
    "susy_distributed": ("--rounds", "300"),
    "stock_nowcast": ("--rounds", "300", "--learners", "8"),
}


def reference_output(rel: str, argv=()) -> str:
    """stdout of the reference script ``rel`` run as ``__main__``."""
    path = ROOT / rel
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [str(path), *argv]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(path), run_name="__main__")
    except SystemExit as exit_:
        assert exit_.code in (None, 0), f"{rel} exited with {exit_.code}"
    finally:
        sys.argv = saved
    return buf.getvalue()


def load_script(rel: str):
    """The port's script ``rel`` as a module (its ``main`` not run)."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "_port_" + path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_rff_spec(dim, num_features, gamma=1.0, seed=0):
    """The port's ``RFFSpec`` for these arguments holding the
    reference's own draw of (W, b)."""
    spec = jrff.RFFSpec(dim=dim, num_features=num_features, gamma=gamma,
                        seed=seed)
    return convert.rff_spec(spec, *jrff.rff_params(spec))


def port_output(rel: str, argv=(), hand_in: bool = True) -> str:
    """stdout of the port's script ``rel`` through ``main`` on the CPU,
    its random features the reference's draw handed in, or with
    ``hand_in=False`` its own."""
    script = load_script(rel)
    if hand_in and hasattr(script, "RFFSpec"):
        script.RFFSpec = reference_rff_spec
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = script.main([*argv, "--device", "cpu"])
    assert rc == 0, f"{rel} returned {rc}"
    return buf.getvalue()


def half_unit(token: str) -> float:
    """Half a unit of the last digit ``token`` was printed with."""
    mantissa, _, exponent = token.lower().partition("e")
    decimals = len(mantissa.partition(".")[2])
    return 0.5 * 10.0 ** (int(exponent or 0) - decimals)


def assert_same_output(got: str, want: str, label: str) -> None:
    """Line for line: the text between numbers equal, integers equal,
    floats within the parity pair plus half a unit of the last digit."""
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines), (label, got, want)
    for i, (g, w) in enumerate(zip(got_lines, want_lines)):
        where = f"{label}, line {i}: {g!r} against {w!r}"
        assert NUMBER.split(g) == NUMBER.split(w), where
        for gt, wt in zip(NUMBER.findall(g), NUMBER.findall(w)):
            if INTEGER.fullmatch(wt):
                assert gt == wt, where
                continue
            limit = (PARITY_ATOL + PARITY_RTOL * abs(float(wt))
                     + half_unit(wt))
            assert abs(float(gt) - float(wt)) <= limit, \
                f"{where}: {gt} against {wt}, limit {limit}"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one intra-op thread for the module (as
    tests/test_torch_vlm.py a test): beside JAX's threads in one process
    the default team ran the quickstart about five times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference():
    """Each reference script's output, run once a module on first use."""
    outputs = {}

    def get(name: str) -> str:
        if name not in outputs:
            outputs[name] = reference_output(f"examples/{name}.py",
                                             SCRIPTS[name])
        return outputs[name]

    return get


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_example_prints_the_reference_table(name, reference):
    want = reference(name)
    got = port_output(f"examples/torch/{name}.py", SCRIPTS[name])
    assert_same_output(got, want, name)


#: the scripts that draw random features from ``RFFSpec(seed)``
RFF_SCRIPTS = ("rff_quickstart", "serve_quickstart")


@pytest.mark.parametrize("name", RFF_SCRIPTS)
def test_rff_example_prints_the_reference_table_from_its_own_draw(
        name, reference):
    rel = f"examples/torch/{name}.py"
    assert hasattr(load_script(rel), "RFFSpec")
    got = port_output(rel, SCRIPTS[name], hand_in=False)
    assert_same_output(got, reference(name), name)


def test_half_unit_and_the_comparison_refuse_what_they_should():
    assert half_unit("856.9") == pytest.approx(0.05)
    assert half_unit("1.23e-04") == pytest.approx(0.5e-6)
    assert half_unit("751") == 0.5
    assert_same_output("a 1.00 b 7\n", "a 1.004 b 7\n", "within")
    with pytest.raises(AssertionError):
        assert_same_output("a 1.00 b 8\n", "a 1.00 b 7\n", "integer")
    with pytest.raises(AssertionError):
        assert_same_output("a 1.10 b 7\n", "a 1.00 b 7\n", "float")
    with pytest.raises(AssertionError):
        assert_same_output("a  1.00 b 7\n", "a 1.00 b 7\n", "columns")
    with pytest.raises(AssertionError):
        assert_same_output("a 1.00\n", "a 1.00\nb\n", "lines")
