"""The port's serve example against the reference's, on the CPU.

``examples/serve_lm_torch.py`` serves the reference's reduced granite-3-8b
weights (``PRNGKey(0)``) and prompts (``PRNGKey(1)``), carried across, and
must print the reference example's wave lines and count of decoded tokens
(the reference run at a smaller traffic than its defaults, to stay cheap:
its op-by-op engine compiles at every new shape). With both packages'
reduced config in float32 it must also emit for every request the greedy
tokens that the reference engine emitted for it in the example's run.
The script runs as a program with ``--device cpu`` and ends with its
``OK`` line, and refuses the CPU unless asked.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import get_arch as jget, reduced as jreduced
from repro.data.pipeline import make_prompts as jmake_prompts
from repro.models import build as jbuild
from repro.serve import engine as jengine

from repro_torch import convert
from repro_torch.configs import get_arch, reduced

from _torch_examples_common import _example, _reference_output, \
    run_program

SERVE_ARGS = ["--requests", "9", "--max-new", "4", "--max-seqs", "4"]
OK = "serve_lm OK — continuous batching with page reuse"

serve = _example("serve_lm_torch")


def _record_tokens(monkeypatch):
    """Each request's tokens as the reference engine emits them, in the
    order the requests are admitted: the first at admission, then one for
    every decode step that leaves its slot live."""
    outs, req_of = [], {}
    admit, decode_step = jengine.Engine.admit, jengine.Engine.decode_step

    def admit_rec(self, state, prompts):
        free = np.flatnonzero(~np.asarray(state.table.active))
        state = admit(self, state, prompts)
        toks = np.asarray(state.tokens)
        for s in free[:len(prompts)]:
            req_of[s] = len(outs)
            outs.append([int(toks[s])])
        return state

    def decode_rec(self, state):
        state = decode_step(self, state)
        live = np.asarray(state.table.active & ~state.done)
        toks = np.asarray(state.tokens)
        for s, r in req_of.items():
            if live[s]:
                outs[r].append(int(toks[s]))
        return state
    monkeypatch.setattr(jengine.Engine, "admit", admit_rec)
    monkeypatch.setattr(jengine.Engine, "decode_step", decode_rec)
    return outs


def _serve_both(monkeypatch, **dtype):
    """The reference example's printed lines and each request's tokens,
    and the port's ``run`` on the same weights and prompts: ``(ref lines,
    ref tokens, port lines, tokens decoded, port tokens)``. ``dtype``
    overrides the reduced config's in both packages."""
    if dtype:
        monkeypatch.setattr(jconfigs, "reduced",
                            lambda a, **kw: jreduced(a, **kw, **dtype))
    ref_tokens = _record_tokens(monkeypatch)
    ref = _reference_output("serve_lm.py", SERVE_ARGS, monkeypatch)
    n_req, max_new, max_seqs = (int(a) for a in SERVE_ARGS[1::2])
    jcfg = jreduced(jget("granite-3-8b"), **dtype)
    cfg = reduced(get_arch("granite-3-8b"), **dtype)
    params = jax.tree.map(np.asarray,
                          jbuild(jcfg).init(jax.random.PRNGKey(0)))
    model = convert.lm_params_from_numpy(cfg, params, "cpu")
    prompts = jmake_prompts(jax.random.PRNGKey(1), n_req, cfg.vocab,
                            min_len=4, max_len=20)
    engine = serve.Engine(cfg, model, serve.engine_config(max_seqs),
                          device="cpu")
    return (ref, ref_tokens) + serve.run(engine, prompts, max_new)


def _same_waves(ref, lines, total_new):
    n_req, _, max_seqs = (int(a) for a in SERVE_ARGS[1::2])
    assert lines == [ln for ln in ref if ln.startswith("wave ")]
    assert len(lines) == -(-n_req // max_seqs)
    tail = next(ln for ln in ref if ln.startswith("waves="))
    assert tail.startswith(f"waves={len(lines)}  tokens decoded="
                           f"{total_new} in ")
    assert ref[-1] == OK


def test_serve_prints_the_reference_examples_waves(monkeypatch):
    """At the example's own bfloat16 the wave lines and the count of
    decoded tokens are the reference's; the tokens themselves are not
    held here, since bfloat16 rounding breaks near-ties of the greedy
    choice differently in the two packages."""
    ref, ref_tokens, lines, total_new, tokens = _serve_both(monkeypatch)
    _same_waves(ref, lines, total_new)
    assert [len(t) for t in tokens] == [len(t) for t in ref_tokens]
    assert total_new == sum(len(t) - 1 for t in tokens)


def test_serve_emits_the_reference_engines_tokens(monkeypatch):
    """In float32 (both packages' reduced config overridden) every
    request's greedy tokens are the reference engine's, position by
    position, as the reference example drove it."""
    ref, ref_tokens, lines, total_new, tokens = _serve_both(
        monkeypatch, dtype="float32")
    _same_waves(ref, lines, total_new)
    assert len(tokens) == int(SERVE_ARGS[1])
    assert tokens == ref_tokens


def test_serve_runs_as_a_program_on_the_cpu():
    run_program("serve_lm_torch.py", ["--requests", "3", "--max-new", "3",
                                      "--max-seqs", "2"], OK)


def test_serve_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main([])
