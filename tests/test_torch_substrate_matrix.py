"""``tools/substrate_matrix_torch.py`` against ``tools/substrate_matrix.py``,
on the CPU.

The reference's matrix runs once (``runpy`` as ``__main__``, stdout
captured, its exit code checked); the port's through ``main(["--device",
"cpu"])``.  Every line must equal the reference's as text once
``backend=pallas`` reads ``backend=kernels``: the same sync counts and
bytes for each of the 3 substrates x 2 kinds x 2 backends through the
engine, the async harness and serving, every cell ``ok=True``, and each
cell's two backends bitwise equal in their ledgers.  The RFF cells hold
the reference's draw of the random features, handed in
(tests/test_torch_examples.py, ``reference_rff_spec``) and, in a second
run, drawn by the port's own ``RFFSpec(seed)``.  At the matrix's sizes the port's engage-aware
dispatch hands a kernel one call only: the SV ``kernels`` cells' async
aggregates truncate 192 slots through ``quadform`` (the reference
compresses its aggregate on the plain path whatever its backend).
"""
import pytest

from test_torch_examples import (load_script, one_torch_thread,  # noqa: F401
                                 port_output, reference_output)

TOOL = "tools/substrate_matrix.py"
PORT_TOOL = "tools/substrate_matrix_torch.py"


@pytest.fixture(scope="module")
def reference():
    return reference_output(TOOL)


@pytest.fixture(scope="module")
def port():
    return port_output(PORT_TOOL)


def test_matrix_lines_equal_the_reference_with_kernels_for_pallas(
        reference, port):
    want = reference.replace("backend=pallas", "backend=kernels")
    assert port.splitlines() == want.splitlines()


def test_matrix_lines_equal_the_reference_from_its_own_draw(reference):
    want = reference.replace("backend=pallas", "backend=kernels")
    own = port_output(PORT_TOOL, hand_in=False)
    assert own.splitlines() == want.splitlines()


def test_matrix_has_every_cell_ok_and_bitwise_backends(port):
    lines = port.splitlines()
    assert sum(line.endswith(" ok=True") for line in lines) == 12
    assert sum(line.endswith(" backend_ledger_bitwise_equal=True")
               for line in lines) == 6
    assert lines[-1] == "substrate_matrix: 0 failures"


def test_matrix_exits_non_zero_when_an_invariant_fails(monkeypatch, capsys):
    tool = load_script(PORT_TOOL)
    # a wrong per-sync charge: every fixed-payload cell's bytes disagree
    monkeypatch.setattr(tool, "sync_bytes_linear", lambda p, m: 1)
    assert tool.main(["--device", "cpu"]) == 1
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.endswith(" ok=False") for line in lines) == 8
    assert lines[-1] == "substrate_matrix: 8 failures"


def test_matrix_engages_only_the_sv_aggregates_truncation(monkeypatch,
                                                           capsys):
    """Which calls the engage-aware dispatch hands a kernel (on the card
    each launches one; on the CPU the wrapper runs its plain version):
    only the SV ``kernels`` cells' async aggregates, whose truncation
    holds 2 n tau = 192 slots (128 and over engage), one ``quadform``
    form a sync.  Budget 32, D 64 and m 3 engage nothing else."""
    from repro_torch.kernels import ops

    engaged, forms = [], []
    engages, quadform_spec = ops.engages, ops.quadform_spec

    def recording_engages(*dims):
        hit = engages(*dims)
        if hit:
            engaged.append(dims)
        return hit

    def recording_quadform_spec(spec, X, *a, **kw):
        forms.append(tuple(X.shape))
        return quadform_spec(spec, X, *a, **kw)

    monkeypatch.setattr(ops, "engages", recording_engages)
    monkeypatch.setattr(ops, "quadform_spec", recording_quadform_spec)
    assert load_script(PORT_TOOL).main(["--device", "cpu"]) == 0
    syncs = sum(int(line.split(" async_syncs=")[1].split()[0])
                for line in capsys.readouterr().out.splitlines()
                if line.startswith("substrate=sv ")
                and " backend=kernels " in line)
    assert syncs == 8 + 20
    assert forms == [(1, 2 * 3 * 32, 8)] * syncs
    # compression's check on the mix, then the quadform wrapper's own
    assert engaged == [(192,), (192, 192)] * syncs
