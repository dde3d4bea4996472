"""``repro_torch.launch.serve --checkpoint`` against the JAX package's
``repro.launch.serve --checkpoint`` on the CPU: a SMOKE stablelm-1.6b
trained a few steps by the JAX package and saved with
``repro.training.checkpoint.save`` serves through both CLIs with the same
prompts, float32 greedy, and the ``IDS`` lines are equal (through the
port's plain path and its kernel route, which takes the plain versions on
the CPU).  A checkpoint of another architecture is refused.  The serve
flags ``--k 2 --opportunistic --analyze warn`` give equal ``IDS`` lines and
equal ``[analysis]`` verdicts in both CLIs, and ``--analyze strict`` refuses
the same grammar in both."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import pytest

from repro.configs import get_config
from repro.core import grammars
from repro.core.sampling import GrammarSampler
from repro.models import build_model
from repro.tokenizer import train_bpe
from repro.training import checkpoint, optimizer as opt
from repro.training.data import GrammarLMDataset
from repro.training.train_loop import make_train_step

FLAGS = ["--print-ids", "--max-tokens", "12", "--prompts", "3", "--slots",
         "2"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("ck")
    tok = train_bpe(GrammarSampler(grammars.load("json"), seed=0).corpus(80),
                    vocab_size=320)
    cfg = dataclasses.replace(get_config("stablelm-1.6b", smoke=True),
                              vocab_size=tok.vocab_size)
    m = build_model(cfg)
    params = m.init(jax.random.PRNGKey(0))
    step = make_train_step(m, opt.AdamWConfig(lr=3e-3, schedule="constant",
                                              warmup_steps=1))
    state = opt.init_state(params)
    data = GrammarLMDataset(tok, "json", seq_len=32).batches(4)
    for _ in range(4):
        params, state, _ = step(params, state, {
            k: jnp.asarray(v) for k, v in next(data).items()})
    checkpoint.save(path, params, meta={"arch": cfg.arch_id})
    tok.save(path / "tokenizer.json")
    return path


def _ids(text):
    return [ln for ln in text.splitlines() if ln.startswith("IDS ")]


def _run_reference(args):
    """``repro.launch.serve`` with ``args`` (it reads ``sys.argv``) ->
    its standard output."""
    import contextlib
    import io

    from repro.launch import serve
    argv, out = sys.argv, io.StringIO()
    sys.argv = ["serve"] + args
    try:
        with contextlib.redirect_stdout(out):
            serve.main()
    finally:
        sys.argv = argv
    return out.getvalue()


def _verdicts(text):
    """The ``[analysis]`` lines without their seconds."""
    return [ln.rsplit(",", 1)[0] for ln in text.splitlines()
            if ln.startswith("[analysis] ")]


@pytest.fixture(scope="module")
def reference_ids(ckpt):
    ids = _ids(_run_reference(["--checkpoint", str(ckpt)] + FLAGS))
    assert len(ids) == 3
    return ids


@pytest.mark.parametrize("extra", [[], ["--kernels"]])
def test_port_serves_a_reference_checkpoint_with_equal_ids(
        ckpt, reference_ids, extra, capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--checkpoint", str(ckpt)] + FLAGS
               + extra)
    assert _ids(capsys.readouterr().out) == reference_ids


def test_checkpoint_of_another_arch_is_refused(ckpt):
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="stablelm-1.6b-smoke"):
        serve.main(["--device", "cpu", "--checkpoint", str(ckpt), "--arch",
                    "falcon-mamba-7b"])
    with pytest.raises(ValueError, match="--no-smoke"):
        serve.main(["--device", "cpu", "--checkpoint", str(ckpt),
                    "--no-smoke"])


SERVE_FLAGS = ["--k", "2", "--opportunistic", "--analyze", "warn"]


def test_serve_flags_match_reference(ckpt, capsys):
    from repro_torch.launch import serve
    want = _run_reference(["--checkpoint", str(ckpt)] + FLAGS + SERVE_FLAGS)
    serve.main(["--device", "cpu", "--checkpoint", str(ckpt)] + FLAGS
               + SERVE_FLAGS)
    got = capsys.readouterr().out
    assert len(_ids(want)) == 3 and _ids(got) == _ids(want)
    assert _verdicts(want) == _verdicts(got) and len(_verdicts(got)) == 1


def test_analyze_strict_refuses_the_same_grammar(ckpt):
    from repro.core.analysis import AnalysisError as JAnalysisError
    from repro_torch.core.analysis import AnalysisError
    from repro_torch.launch import serve
    strict = ["--checkpoint", str(ckpt), "--grammar", "json", "--analyze",
              "strict", "--prompts", "1", "--max-tokens", "4"]
    with pytest.raises(JAnalysisError, match="'json' failed"):
        _run_reference(strict)
    with pytest.raises(AnalysisError, match="'json' failed"):
        serve.main(["--device", "cpu"] + strict)
