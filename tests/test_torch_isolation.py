"""Guards that keep the PyTorch port honest:

 - every ``repro_torch`` module imports in a process where ``jax`` and
   ``repro`` cannot be imported, and no source line of the port, of
   ``chip_smoke.py`` or of the port's timing tools imports either;
 - the copied framework-free modules equal their ``repro`` originals after
   the ``repro.`` -> ``repro_torch.`` import rewrite, so they cannot drift;
   a near copy equals its original but for the lines it names;
 - the entry points (the serve CLI with and without ``--checkpoint``, the
   trainer CLI, its ``--mesh`` and ``--fake-devices``) refuse to run
   without ``device="cpu"`` when no card is visible, and both CLIs take
   every flag of the JAX package's;
 - the kernel wrappers take their plain versions on CPU tensors and leave
   the launch counters at 0.
"""
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
COPIED = (sorted(p.relative_to(SRC / "repro")
                 for d in ("core", "tokenizer", "configs")
                 for p in (SRC / "repro" / d).glob("*.py"))
          + [pathlib.Path(p) for p in ("training/data.py",
                                       "serving/request.py",
                                       "serving/session.py",
                                       "serving/prefix_cache.py",
                                       "analysis/__init__.py",
                                       "analysis/cli.py",
                                       "analysis/report.py", "analyze.py")])
# near copies: rel path -> the port's lines that may differ from the
# original's at the same position; every other line is equal.  The audit of
# faults.py reads the cache lengths of a CUDA tensor, which numpy cannot
# take without a copy to the host; the docstrings of journal.py and
# supervisor.py leave out the JAX package's PR and issue numbers.
# The roofline's analytic FLOP and byte model is the JAX package's line
# for line; its docstring, the chip's constants and the dry run's records
# and report files are the H100's and the port's.
NEAR_COPIES = {
    "launch/roofline.py": {
        '"""Roofline analysis of the port, on the H100 '
        "(``repro.launch.roofline``'s).",
        "  compute    = FLOPs / (chips * 989e12)            "
        "[bf16 tensor cores, H100]",
        "  memory     = HBM bytes / (chips * 3.35e12)",
        "  collective = per-device collective bytes / 450e9 "
        "[NVLink, each way]",
        "The constants are the NVIDIA H100 SXM data sheet's "
        "(``launch.mesh``), not",
        "measurements.  The FLOPs and HBM bytes below are the JAX package's",
        "analytic model, copied line for line, so the two packages' "
        "rooflines",
        "differ only by the two chips' constants.  The dry run's own counts",
        "(``cost.flops_per_device`` from ``torch.utils.flop_counter``) "
        "cover",
        "every op it runs, including replicated ones, so they are kept "
        "beside it.",
        "   FlopCounterMode on the port's forward in tests);",
        " - collective bytes come from the dry run's eager step, which "
        "issues",
        "   every layer's collectives (``launch.calibrate`` checks the "
        "count",
        "   against the JAX package's two-point fit:",
        "   bytes(R) = base + R * per_layer).",
        "from repro_torch.launch.mesh import HBM_BW, LINK_BW, "
        "PEAK_FLOPS_BF16",
        '    p = ART / "dryrun_torch" / f"{arch}_{shape}_{mesh}.json"',
        "    coll_t = coll_bytes / LINK_BW          "
        "# dry-run bytes are per-device",
        '    "compute_s": ("compute-bound: raise tensor-core use — larger '
        'per-device "',
        '    out = ART / "roofline_torch.json"',
    },
    "serving/faults.py": {
        '    lens = np.asarray(sched.cache["len"].cpu())',
    },
    "serving/journal.py": {
        "The durability contract: a process crash — SIGKILL at",
    },
    "serving/supervisor.py": {
        "The scheduler quarantines failures to their row; its audits "
        "demote escaped",
        '    level 0  "fused"   device-resident sync_n block loop',
    },
}
IMPORT_RE = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|repro)(\.|\s|$)")


def _rewrite(text: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", text)


def test_port_imports_without_jax_or_repro():
    # every module file, namespace subpackages (kernels/*/, launch/) too
    names = sorted(".".join(p.relative_to(SRC).with_suffix("").parts)
                   .removesuffix(".__init__")
                   for p in PORT.rglob("*.py"))
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "assert sys.modules['jax'] is None and sys.modules['repro'] is None\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "repro_torch.launch.serve" in names
    assert "repro_torch.kernels.decode_attention.kernel" in names


def test_no_source_line_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if IMPORT_RE.match(line)]
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("tool", ["kernel_variants.py",
                                  "time_decode_attention.py",
                                  "time_split_attention.py",
                                  "time_mamba_scan.py",
                                  "time_ssd_scan.py",
                                  "time_masked_argmax.py"])
def test_port_tool_imports_no_jax_or_repro(tool):
    """The port's timing tools run on the card's machine, which has no
    JAX: no line of theirs imports it or the JAX package."""
    lines = (ROOT / "tools" / tool).read_text().splitlines()
    bad = [f"{tool}:{i}: {line.strip()}"
           for i, line in enumerate(lines, 1) if IMPORT_RE.match(line)]
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("rel", [str(p) for p in COPIED])
def test_copied_module_equals_rewritten_original(rel):
    original = (SRC / "repro" / rel).read_text()
    assert (PORT / rel).read_text() == _rewrite(original)


@pytest.mark.parametrize("rel", sorted(NEAR_COPIES))
def test_near_copy_differs_only_in_named_lines(rel):
    original = _rewrite((SRC / "repro" / rel).read_text()).splitlines()
    port = (PORT / rel).read_text().splitlines()
    assert len(port) == len(original)
    differ = {got for want, got in zip(original, port) if got != want}
    assert differ == NEAR_COPIES[rel]


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")


def test_entry_points_refuse_without_a_card(small_tokenizer):
    _no_card()
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.serving import ServingEngine
    model = build_model(get_config("stablelm-1.6b", smoke=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"stack": {}}, model.cfg)
    params = model.init(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, params, small_tokenizer)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--prompts", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--checkpoint", str(ROOT / "no-such-checkpoint")])
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])
    for mesh in ("1x1", "2x2"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--smoke", "--steps", "1", "--mesh", mesh])
    with pytest.raises(ValueError, match="--device cpu"):
        train.main(["--smoke", "--mesh", "2x2", "--fake-devices", "4"])


def test_chip_smoke_fails_without_a_card(tmp_path):
    _no_card()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok": true' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok": true' not in out.stdout


def test_cpu_tensors_take_the_plain_versions():
    from repro_torch.kernels.decode_attention import kernel as attn_kernel
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.masked_sample import kernel as mask_kernel
    from repro_torch.kernels.masked_sample.ops import masked_argmax
    before = (attn_kernel.decode_attention_cuda.launches,
              mask_kernel.masked_argmax_packed.launches)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 1, 2, 2, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 8, 2, 16)).astype(np.float32))
    out = decode_attention(q, k, k, torch.tensor([3, 0], dtype=torch.int32))
    assert out.shape == (2, 1, 2, 2, 16) and torch.all(out[1] == 0)
    idx, val = masked_argmax(torch.zeros((2, 40)),
                             torch.tensor([[4, 0], [0, 0]],
                                          dtype=torch.int32))
    assert idx.tolist() == [2, 0]
    assert (attn_kernel.decode_attention_cuda.launches,
            mask_kernel.masked_argmax_packed.launches) == before == (0, 0)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launch wrappers never run a plain version themselves."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.masked_sample.kernel import masked_argmax_packed
    with pytest.raises(ValueError, match="CUDA"):
        masked_argmax_packed(torch.zeros((1, 32)),
                             torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(torch.zeros((1, 1, 1, 1, 8)),
                              torch.zeros((1, 4, 1, 8)),
                              torch.zeros((1, 4, 1, 8)), 1)


@pytest.mark.parametrize("name", ["decode_attention", "decode_attention_split",
                                  "masked_argmax_packed",
                                  "masked_argmax_bytes", "mamba_scan",
                                  "ssd_scan"])
def test_kernel_wrappers_refuse_operands_that_require_grad(name):
    """A check before any other: an operand that requires grad is refused
    (the kernels have no backward); under ``no_grad`` the same call goes on
    to the wrapper's own checks, which refuse CPU tensors."""
    from test_torch_kernels_cuda import wrapper_calls
    fn, args = wrapper_calls(torch, "cpu", requires_grad=True)[name]
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fn(*args)


@pytest.mark.parametrize("cli", ["serve", "train"])
def test_cli_takes_every_flag_of_the_reference(cli):
    """The port's serve and trainer CLIs accept every flag of the JAX
    package's (and add only ``--device`` and ``--dtype``)."""
    flag = re.compile(r'add_argument\("(--[a-z-]+)"')
    ref = set(flag.findall((SRC / "repro" / "launch" / f"{cli}.py")
                           .read_text()))
    port = set(flag.findall((PORT / "launch" / f"{cli}.py").read_text()))
    assert ref <= port and port - ref == {"--device", "--dtype"}
