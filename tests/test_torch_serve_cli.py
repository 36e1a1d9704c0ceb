"""The port's serving launcher against the JAX package's, on the CPU.

The port's parser must take every flag of the JAX launcher
(``repro/launch/serve.py``, read here by its syntax tree, not run) whose
feature the port has, with the same choices and defaults; the flags of
layers not yet ported stay absent.  Then the repaired flags serve to the end
at smoke size through the plain versions of the kernels.
"""
import ast
import pathlib

import pytest

from repro_torch.launch import serve

ROOT = pathlib.Path(__file__).resolve().parents[1]
# flags of the JAX launcher whose layer the port does not have yet: the
# observability layer (trace, metrics, telemetry, XLA profile)
NOT_PORTED = {"--trace", "--metrics-out", "--xla-profile", "--telemetry"}
# choices of a ported flag that belong to a layer not ported: none
NOT_PORTED_CHOICES: dict = {}


def _jax_flags() -> dict:
    """Every option of the JAX serve launcher: {flag: (choices, default)};
    a BooleanOptionalAction adds its ``--no-`` twin."""
    flags = {}
    tree = ast.parse((ROOT / "src/repro/launch/serve.py").read_text())
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            continue
        kw = {k.arg: k.value for k in node.keywords}
        flag = node.args[0].value
        choices = (set(ast.literal_eval(kw["choices"])) if "choices" in kw
                   else None)
        action = ast.unparse(kw["action"]) if "action" in kw else ""
        default = (ast.literal_eval(kw["default"]) if "default" in kw
                   else False if action == "'store_true'" else None)
        flags[flag] = (choices, default)
        if action.endswith("BooleanOptionalAction"):
            flags["--no-" + flag[2:]] = (None, default)
    return flags


def _port_actions() -> dict:
    return {opt: act for opt, act in
            serve.build_parser()._option_string_actions.items()
            if opt.startswith("--")}


def test_port_parser_takes_every_ported_jax_flag():
    jax_flags, port = _jax_flags(), _port_actions()
    assert NOT_PORTED <= set(jax_flags), "a listed flag left the JAX launcher"
    missing = set(jax_flags) - NOT_PORTED - set(port)
    assert not missing, f"JAX serve flags of ported features missing: {missing}"
    assert not NOT_PORTED & set(port), "a flag of an unported layer is offered"
    for flag, (choices, default) in jax_flags.items():
        if flag in NOT_PORTED:
            continue
        act = port[flag]
        if choices is not None:
            assert set(act.choices) == choices - NOT_PORTED_CHOICES.get(flag, set()), flag
        if not flag.startswith("--no-"):
            assert act.default == default, flag


def test_port_parser_reads_the_repaired_flags():
    args = serve.build_parser().parse_args([
        "--arch", "qwen2-1.5b", "--attn-mode", "chunked", "--no-pack-prefill",
        "--audit", "--max-retries", "3", "--deadline", "2.5"])
    assert (args.attn_mode, args.pack_prefill, args.audit, args.max_retries,
            args.deadline) == ("chunked", False, True, 3, 2.5)
    args = serve.build_parser().parse_args(["--arch", "qwen2-1.5b", "--pack-prefill"])
    assert args.pack_prefill and not args.audit and args.deadline is None


@pytest.mark.parametrize("argv", [
    ["--attn-mode", "chunked"],
    ["--attn-mode", "chunked", "--cache-dtype", "fp2fx8", "--decode-loop", "host"],
], ids=["lockstep-chunked", "lockstep-chunked-fp2fx8-host"])
def test_launcher_serves_chunked_mode(argv, capsys):
    serve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prefill", "8", "--max-new", "3", *argv])
    rows = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[")]
    assert len(rows) == 2


@pytest.mark.parametrize("extra", [
    ["--attn-mode", "kernel"],
    ["--attn-mode", "chunked", "--prefix-cache", "--max-retries", "4"],
], ids=["kernel", "chunked-prefix"])
def test_launcher_serves_continuous_with_repaired_flags(extra, capsys):
    """``--no-pack-prefill``, ``--audit`` and ``--deadline`` reach the
    scheduler: every request completes inside its deadline and the pool
    audit runs at its checkpoints."""
    serve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                "--scheduler", "continuous", "--kv-layout", "paged",
                "--no-pack-prefill", "--audit", "--deadline", "60",
                "--batch", "4", "--n-slots", "2", "--prefill", "10",
                "--max-new", "4", "--prefill-chunk", "4", *extra])
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if ln.startswith("[")]
    assert len(rows) == 4 and "FAILED" not in out and "CANCELLED" not in out
    stats = ast.literal_eval(out.split("stats: ", 1)[1].splitlines()[0])
    assert stats["audits"] > 0


def test_launcher_deadline_reaches_each_request(capsys):
    """A deadline of 0 s expires each request at the first checkpoint after
    its admission: the one admitted to the single slot after one step, the
    rest in the queue."""
    serve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                "--scheduler", "continuous", "--deadline", "0", "--batch", "3",
                "--n-slots", "1", "--decode-burst", "1", "--max-new", "20"])
    out = capsys.readouterr().out
    assert out.count("FAILED(deadline)") == 3


@pytest.mark.parametrize("mode", [
    ["--spec-mode", "ngram"],
    ["--spec-mode", "model", "--draft-model", "qwen2-1.5b", "--draft-k", "3"],
], ids=["ngram", "model"])
def test_launcher_serves_spec_paged(mode, capsys):
    """``--scheduler spec`` over a paged pool in both drafter modes: every
    request completes, the audit runs, and the launcher prints the JAX
    launcher's ``spec:`` summary line with the step, draft and acceptance
    counts."""
    serve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                "--scheduler", "spec", "--kv-layout", "paged", "--page-size", "8",
                "--attn-mode", "kernel", "--cache-dtype", "fp2fx8", "--audit",
                "--batch", "3", "--n-slots", "2", "--prefill", "10", "--max-new", "6",
                *mode])
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if ln.startswith("[")]
    assert len(rows) == 3 and "FAILED" not in out and "CANCELLED" not in out
    spec = [ln for ln in out.splitlines() if ln.startswith("spec: ")]
    assert len(spec) == 1 and "steps=" in spec[0] and "rate " in spec[0]
    stats = ast.literal_eval(out.split("stats: ", 1)[1].splitlines()[0])
    assert stats["spec_steps"] > 0 and stats["audits"] > 0
    assert stats["draft_tokens"] > 0 or mode[1] == "ngram"
