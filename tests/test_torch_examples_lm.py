"""``examples/torch/train_lm_dynamic.py`` against
``examples/train_lm_dynamic.py``, on the CPU.

Both run ``mamba2_130m`` at full width cut to 4 layers (bf16, the
config's) with ``--steps 2 --learners 2 --batch 1 --seq 16 --ckpt-every
1``: the reference once (``runpy`` as ``__main__``), the port through
its ``train`` loop from the reference's initial state
(``init_train_state(jax.random.PRNGKey(0), ...)`` carried across by
``convert.train_state``).  The token batches come from
``np.random.default_rng(0)`` on both sides.  Held: the header and the
closing lines as text with their numbers (tests/test_torch_examples.py's
rule), each step line's ``syncs`` and ``comm`` equal, its loss and
divergence within tests/test_torch_ssm.py's ``_close`` at ``BF16_TOL``;
``s/step`` is wall time and not compared.  Every checkpoint the port's
loop writes loads in the reference's ``checkpoint.restore``, bitwise the
port's state at that step.
"""
import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get as jget
from repro.launch import train as jtrain
from repro.optim import OptimizerConfig as JOpt

from repro_torch import checkpoint as tckpt
from repro_torch import convert
from repro_torch.tree import leaves

from test_torch_examples import (assert_same_output, load_script,
                                 one_torch_thread,  # noqa: F401
                                 reference_output)
from test_torch_ssm import BF16_TOL, _close

SCRIPT = "examples/train_lm_dynamic.py"
PORT_SCRIPT = "examples/torch/train_lm_dynamic.py"
FLAGS = ("--steps", "2", "--learners", "2", "--batch", "1", "--seq", "16",
         "--ckpt-every", "1")
STEP = re.compile(r"step\s+(\d+) loss=\s*(\S+) syncs=\s*(\d+) "
                  r"divergence=\s*(\S+) comm=\s*(\S+)GB \(\S+s/step\)$")
CKPT = re.compile(r"  checkpoint -> (.*)$")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ckpt_dir = tmp_path_factory.mktemp("reference_ckpt")
    return reference_output(SCRIPT, FLAGS + ("--ckpt-dir", str(ckpt_dir)))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's output from the reference's initial state, and each
    state its loop handed to ``checkpoint.save_step``."""
    script = load_script(PORT_SCRIPT)
    ckpt_dir = tmp_path_factory.mktemp("port_ckpt")
    args = script.parse_args([*FLAGS, "--ckpt-dir", str(ckpt_dir),
                              "--device", "cpu"])
    jcfg = jget("mamba2_130m").with_(n_layers=4)
    cfg = script.model_config(args)
    assert cfg.n_layers == jcfg.n_layers == 4 and cfg.dtype == "bfloat16"
    opt = script.optimizer_config(args)
    jstate = jtrain.init_train_state(
        jax.random.PRNGKey(0), jcfg, args.learners,
        JOpt(kind=opt.kind, lr=opt.lr, momentum=opt.momentum,
             grad_clip=opt.grad_clip))
    state = convert.train_state(jstate, cfg, "cpu")
    saved = {}
    save_step = tckpt.save_step

    def recording_save_step(directory, step, tree):
        saved[step] = tree
        return save_step(directory, step, tree)

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(script.ckpt, "save_step", recording_save_step)
        with contextlib.redirect_stdout(buf):
            final = script.train(args, cfg, state, torch.device("cpu"))
    return buf.getvalue(), saved, final


def _split(output: str):
    """(step lines' groups, checkpoint paths, the other lines)."""
    steps, paths, rest = [], [], []
    for line in output.splitlines():
        if m := STEP.match(line):
            steps.append(m.groups())
        elif m := CKPT.match(line):
            paths.append(m.group(1))
        else:
            rest.append(line)
    return steps, paths, "\n".join(rest)


def test_train_lm_prints_the_reference_lines(reference, port):
    got_steps, got_paths, got_rest = _split(port[0])
    want_steps, want_paths, want_rest = _split(reference)
    assert_same_output(got_rest, want_rest, "train_lm_dynamic")
    assert [s[0] for s in got_steps] == [s[0] for s in want_steps] == \
        ["0", "1"]
    for (t, loss, syncs, div, comm), (_, jloss, jsyncs, jdiv, jcomm) in \
            zip(got_steps, want_steps):
        assert syncs == jsyncs and comm == jcomm, t
        _close(np.float32(loss), np.float32(jloss), f"step {t} loss",
               tol=BF16_TOL)
        _close(np.float32(div), np.float32(jdiv), f"step {t} divergence",
               tol=BF16_TOL)
    assert [p.rsplit("/", 1)[1] for p in got_paths] == \
        [p.rsplit("/", 1)[1] for p in want_paths] == \
        ["step_00000001.ckpt", "step_00000002.ckpt"]


def _bits(x) -> bytes:
    if torch.is_tensor(x):
        x = x.detach().contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy().tobytes()
    a = np.asarray(x)
    return (a.view(np.int16) if a.dtype == jnp.bfloat16 else a).tobytes()


def test_port_checkpoints_restore_in_the_reference(port):
    output, saved, final = port
    _, paths, _ = _split(output)
    assert sorted(saved) == [1, 2]
    assert all(a is b for a, b in zip(leaves(saved[2]), leaves(final)))
    for step, path in zip((1, 2), paths):
        state = saved[step]
        # a JAX tree of the port's structure, the leaves' values aside
        like = jax.tree.map(jnp.asarray, convert.to_numpy(state))
        got = jax.tree.leaves(jckpt.restore(path, like))
        want = leaves(state)
        assert len(got) == len(want), step
        for g, w in zip(got, want):
            assert str(g.dtype) == str(w.dtype).replace("torch.", ""), step
            assert _bits(g) == _bits(w), step
