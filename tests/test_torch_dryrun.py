"""The port's dry run and roofline (``repro_torch.launch.dryrun`` /
``.roofline``) against the JAX package's and against the port's live
steps on the CPU.  No reference dry run is compiled.

- ``active_params`` for every LM architecture and ``model_flops`` for
  every (architecture, shape), exactly the reference's;
- ``analyze_record`` and ``markdown_table`` on fixed records in the
  reference's schema, with and without collective bytes: the port with
  its constants patched to the reference's TPU v5e values gives the
  reference's output, and with its own H100 values the reference's
  output under those values (every term scaled by the constants'
  ratio);
- dry-run records of the smoke variant of one architecture per family
  at each shape kind on a (2, 2) mesh: the schema complete, the
  ``null`` fields the named ones, ``flops_global`` equal to a
  FlopCounterMode count of the same step run on the CPU with real
  tensors, the argument bytes those tensors' bytes, the train step
  leaving its ``TrainState`` untouched;
- the CLIs at full width on two decode steps, and what still raises.
"""
import json

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get as jget
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroof
from repro.launch.specs import variant_for as jvariant_for
from repro.models import build as jbuild

from repro_torch.configs import all_arch_ids, get as tget
from repro_torch.core import protocol as tprotocol
from repro_torch.launch import dryrun, roofline as troof
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import NamedMesh
from repro_torch.launch.serve import make_decode_step, make_prefill_step
from repro_torch.models import attention as tattn
from repro_torch.models import build as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.tree import leaves

ARCHS = all_arch_ids()
FAMILY_ARCHS = ("qwen2_5_3b", "olmoe_1b_7b", "mamba2_130m",
                "recurrentgemma_9b", "qwen2_vl_2b", "whisper_large_v3",
                "minicpm3_4b")
# the reference's record schema (repro/launch/dryrun.py::run_one)
SCHEMA = ("arch", "shape", "mesh", "devices", "kind", "flops",
          "bytes_accessed", "transcendentals", "argument_size",
          "output_size", "temp_size", "generated_code_size",
          "collective_bytes", "collective_total", "lower_s", "compile_s",
          "n_collective_ops")
# smoke sizes of the four shapes (the long one past its 16-slot ring)
SMOKE_SHAPES = {"train_4k": dict(kind="train", seq=16, batch=4),
                "prefill_32k": dict(kind="prefill", seq=16, batch=2),
                "decode_32k": dict(kind="decode", seq=16, batch=2),
                "long_500k": dict(kind="decode", seq=40, batch=1)}
SMOKE_MESH = NamedMesh(("data", "model"), (2, 2))


# ---------------------------------------------------------------------------
# Roofline arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_match_reference(arch):
    assert troof.active_params(tget(arch)) == \
        jroof.active_params(jget(arch))


@pytest.mark.parametrize("shape", list(tspecs.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch, shape):
    assert troof.model_flops(tspecs.variant_for(tget(arch), shape), shape) \
        == jroof.model_flops(jvariant_for(jget(arch), shape), shape)


def _records(collectives: bool):
    """Fixed records in the reference's schema: compute-, memory- and
    (with collective bytes) collective-dominated."""
    base = {k: None for k in SCHEMA}
    recs = [
        {**base, "arch": "qwen2_5_3b", "shape": "train_4k", "mesh": "single",
         "devices": 256, "kind": "train", "flops": 9.3235150061568e13,
         "bytes_accessed": 1.2182549702698906e12},
        {**base, "arch": "olmoe_1b_7b", "shape": "decode_32k",
         "mesh": "multi", "devices": 512, "kind": "decode",
         "flops": 4.487e9, "bytes_accessed": 6.25e10},
        {**base, "arch": "whisper_large_v3", "shape": "prefill_32k",
         "mesh": "single", "devices": 256, "kind": "prefill",
         "flops": 2.93e13, "bytes_accessed": 4.1e11},
    ]
    for r, coll in zip(recs, ({"all-reduce": 3.1e9, "all-gather": 2.2e8},
                              {"all-to-all": 5.0e10,
                               "collective-permute": 1.0e6},
                              {"reduce-scatter": 7.5e8})):
        r["collective_bytes"] = coll if collectives else {}
    return recs


def _patch_constants(monkeypatch, module, peak, hbm, link, link_name):
    monkeypatch.setattr(module, "PEAK_FLOPS_BF16", peak)
    monkeypatch.setattr(module, "HBM_BW", hbm)
    monkeypatch.setattr(module, link_name, link)


@pytest.mark.parametrize("collectives", [True, False],
                         ids=["collectives", "no_collectives"])
def test_analyze_record_matches_reference(monkeypatch, collectives):
    recs = _records(collectives)
    v5e = (jmesh.PEAK_FLOPS_BF16, jmesh.HBM_BW, jmesh.ICI_BW)
    h100 = (troof.PEAK_FLOPS_BF16, troof.HBM_BW, troof.LINK_BW)
    assert h100 == (989e12, 3.35e12, 450e9)
    want_v5e = [jroof.analyze_record(r) for r in recs]
    got_h100 = [troof.analyze_record(r) for r in recs]
    # the port under the reference's constants: the reference's output
    with monkeypatch.context() as mp:
        _patch_constants(mp, troof, *v5e, "LINK_BW")
        got_v5e = [troof.analyze_record(r) for r in recs]
        table_v5e = troof.markdown_table(got_v5e)
    assert got_v5e == want_v5e
    want_table = jroof.markdown_table(want_v5e)
    if collectives:
        assert table_v5e == want_table
    else:
        assert table_v5e.endswith(want_table)
        assert table_v5e.startswith("A record without collective bytes")
        assert all(a["collective_s"] == 0.0 for a in got_v5e)
        assert all(a["dominant"] in ("compute", "memory") for a in got_v5e)
    # the reference under the H100's constants: the port's output
    with monkeypatch.context() as mp:
        _patch_constants(mp, jroof, *h100, "ICI_BW")
        want_h100 = [jroof.analyze_record(r) for r in recs]
    assert got_h100 == want_h100
    # every term scales by the constants' ratio
    for g, w in zip(got_h100, want_v5e):
        for term, i in (("compute_s", 0), ("memory_s", 1),
                        ("collective_s", 2)):
            assert g[term] * h100[i] == pytest.approx(w[term] * v5e[i],
                                                      rel=1e-12)


# ---------------------------------------------------------------------------
# Dry-run records at smoke size against the live steps on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def smoke(monkeypatch):
    """The dry run at smoke size: each config's smoke variant (a
    16-token window for the long-context variant), the smoke shapes."""
    monkeypatch.setattr(dryrun, "get", lambda a: tget(a).smoke().with_(
        long_context_window=16))
    for name, shape in SMOKE_SHAPES.items():
        monkeypatch.setitem(tspecs.SHAPES, name, shape)
    monkeypatch.delenv("REPRO_BASELINE", raising=False)


def _real(spec, vocab, rng) -> torch.Tensor:
    """A real CPU tensor for a meta stand-in: tokens below ``vocab``, or
    normal draws."""
    if spec.dtype.is_floating_point:
        return torch.as_tensor(rng.normal(size=tuple(spec.shape)),
                               dtype=spec.dtype)
    return torch.as_tensor(rng.integers(0, vocab, tuple(spec.shape)),
                           dtype=spec.dtype)


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def _live_count(cfg, shape_name, m):
    """(FLOPs, argument bytes) of the live step on real CPU tensors;
    a train step is checked to leave its state untouched."""
    sh = tspecs.SHAPES[shape_name]
    rng = np.random.default_rng(0)
    api = tbuild(cfg)
    if sh["kind"] == "train":
        state = ttrain.init_train_state(0, cfg, m, dryrun.TRAIN_OPT,
                                        device="cpu")
        batch = {k: _real(v, cfg.vocab, rng) for k, v in
                 tspecs.train_batch_specs(cfg, m, sh).items()}
        step = ttrain.make_train_step(cfg, dryrun.TRAIN_PCFG,
                                      dryrun.TRAIN_OPT)
        before = [x.clone() for x in leaves(state)]
        with FlopCounterMode(display=False) as fc:
            new, loss = step(state, batch)
        assert np.isfinite(float(loss))
        for a, b in zip(before, leaves(state)):
            assert torch.equal(a, b)
        assert int(new.step) == 1
        return fc.get_total_flops(), _nbytes((state, batch))
    params = api.init(0, device="cpu")
    B, S = sh["batch"], sh["seq"]
    if sh["kind"] == "prefill":
        batch = {k: _real(v, cfg.vocab, rng) for k, v in
                 tspecs.prefill_batch_specs(cfg, sh).items()}
        caches = api.init_caches(B, S, device="cpu")
        with FlopCounterMode(display=False) as fc:
            logits, _ = make_prefill_step(cfg)(params, batch, caches)
        assert torch.isfinite(logits).all()
        return fc.get_total_flops(), _nbytes((params, batch, caches))
    caches = api.init_caches(B, S + tspecs.CACHE_MARGIN, device="cpu")
    token = torch.as_tensor(rng.integers(0, cfg.vocab, (B, 1)),
                            dtype=torch.int32)
    pos = torch.tensor(S, dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        nxt, _ = make_decode_step(cfg)(params, caches, token, S)
    assert nxt.shape == (B, 1) and int(nxt.max()) < cfg.vocab
    return fc.get_total_flops(), _nbytes((params, caches, token, pos))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "long_500k"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_dry_run_record_matches_live_step(smoke, tmp_path, arch, shape):
    rec = dryrun.run_one(arch, shape, False, str(tmp_path), mesh=SMOKE_MESH)
    assert json.loads((tmp_path / f"{arch}__{shape}__single.json")
                      .read_text()) == rec
    assert set(SCHEMA) <= set(rec)
    assert {k for k, v in rec.items() if v is None} == set(dryrun.NULL_FIELDS)
    assert rec["collective_bytes"] == {}
    assert (rec["devices"], rec["kind"]) == (4, SMOKE_SHAPES[shape]["kind"])
    assert rec["flops"] == rec["flops_global"] / 4
    assert rec["bytes_accessed"] == rec["bytes_accessed_global"] / 4
    assert rec["flops_global"] > 0 and rec["bytes_accessed_global"] > 0
    assert 0 < rec["argument_size"] <= rec["argument_size_global"]
    assert 0 < rec["output_size"] <= rec["output_size_global"]
    cfg = tspecs.variant_for(dryrun.get(arch), shape)
    flops, arg_bytes = _live_count(cfg, shape, 2)
    assert rec["flops_global"] == flops
    assert rec["argument_size_global"] == arg_bytes
    if shape == "train_4k":
        assert rec["m"] == 2
        assert rec["flops_local"] == flops and rec["flops_sync"] == 0
        assert rec["bytes_local"] > 0 and rec["bytes_sync"] > 0


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "mamba2_130m"])
def test_sync_bytes_are_the_live_protocol_round(smoke, tmp_path, arch):
    """``bytes_sync`` is what the live operators move on real CPU tensors
    of the same shapes: the dynamic local conditions, then
    ``apply_protocol``'s continuous round (a sync every round)."""
    rec = dryrun.run_one(arch, "train_4k", False, str(tmp_path),
                         mesh=SMOKE_MESH)
    cfg = tspecs.variant_for(dryrun.get(arch), "train_4k")
    state = ttrain.init_train_state(0, cfg, 2, dryrun.TRAIN_OPT,
                                    device="cpu")
    pstate = state.pstate
    with dryrun.ByteCounter() as nbytes:
        delta = tprotocol._delta_eff(dryrun.TRAIN_PCFG, 1,
                                     pstate.delta_scale, torch.device("cpu"))
        torch.any(tprotocol.local_conditions(state.params, pstate.reference,
                                             delta))
        synced, new = tprotocol.apply_protocol(
            tprotocol.ProtocolConfig(kind="continuous"), state.params,
            pstate)
    assert nbytes.total == rec["bytes_sync"]
    assert (int(new.step), int(new.syncs)) == (1, 1)


def test_baseline_emulation_is_counted_and_restored(smoke, tmp_path,
                                                    monkeypatch):
    """REPRO_BASELINE=1 counts the einsum MoE dispatch and grouped
    attention, and puts the production forms back."""
    sdpa, forward = tattn._sdpa, tmoe.moe_forward
    plain = dryrun.run_one("olmoe_1b_7b", "prefill_32k", False,
                           str(tmp_path), mesh=SMOKE_MESH)
    monkeypatch.setenv("REPRO_BASELINE", "1")
    base = dryrun.run_one("olmoe_1b_7b", "prefill_32k", False,
                          str(tmp_path), mesh=SMOKE_MESH)
    assert (plain["baseline"], base["baseline"]) == (False, True)
    assert base["flops_global"] != plain["flops_global"]
    assert (tattn._sdpa, tmoe.moe_forward) == (sdpa, forward)


# ---------------------------------------------------------------------------
# The CLIs at full width
# ---------------------------------------------------------------------------


def test_cli_dry_run_and_roofline(tmp_path, capsys, monkeypatch):
    """``dryrun.main`` at two full-width decode steps, then
    ``roofline.main`` over their records."""
    monkeypatch.delenv("REPRO_BASELINE", raising=False)
    out = tmp_path / "dryrun"
    for arch in ("qwen2_5_3b", "mamba2_130m"):
        dryrun.main(["--arch", arch, "--shape", "long_500k", "--outdir",
                     str(out)])
    rec = json.loads((out / "qwen2_5_3b__long_500k__single.json")
                     .read_text())
    # one token against the 4096-slot ring of the window variant
    assert rec["flops_global"] == 7_379_877_888
    assert rec["devices"] == 256
    roof = tmp_path / "roofline.json"
    troof.main(["--outdir", str(out), "--json-out", str(roof)])
    text = capsys.readouterr().out
    assert "| qwen2_5_3b | long_500k | single |" in text
    analyzed = json.loads(roof.read_text())
    assert [a["arch"] for a in analyzed] == ["mamba2_130m", "qwen2_5_3b"]
    assert all(a["collective_s"] == 0.0 for a in analyzed)
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen2_5_3b"])


def test_run_all_reports_a_failing_combo(tmp_path):
    records, failures = dryrun.run_all([("no_such_arch", "long_500k")],
                                       False, str(tmp_path))
    assert records == {}
    assert [f[:2] for f in failures] == [("no_such_arch", "long_500k")]
    assert "KeyError" in failures[0][2]


def test_unknown_architecture_and_block_kind_raise():
    """As in the reference: an unknown name raises, and so does a block
    kind no decoder has (``ValueError(kind)`` in both packages)."""
    with pytest.raises(KeyError, match="unknown architecture"):
        tget("no_such_arch")
    tcfg = tget("qwen2_5_3b").smoke().with_(layer_pattern=("attn", "conv"))
    jcfg = jget("qwen2_5_3b").smoke().with_(layer_pattern=("attn", "conv"))
    with pytest.raises(ValueError, match="conv"):
        tbuild(tcfg).init(0, device="cpu")
    with pytest.raises(ValueError, match="conv"):
        jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
