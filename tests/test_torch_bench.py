"""The port's bench, bench_sweep, demo_table and corpus drill vs the JAX
package's repo-level bench.py and tools/, on the CPU at small sizes
(B <= 4, T = 800, one timed iteration).

The JAX bench itself is never run here: its keys are read from bench.py by
an AST parse, and its inline clip synthesis is executed from its own source.
fp32 session tolerances: the base preset's seed-0 networks through 800 LSTM
steps agree to 6e-8 between the frameworks (measured on the CPU); 1e-4
leaves room for another summation order.  A vote fraction counts the signs
of T per-sample logits, so one logit that sits at zero moves it by 1/T."""

import ast
import dataclasses
import functools
import importlib.util
import json
import math
import os
import shlex
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awm_tpu import train as jtr
from awm_tpu.api import InferenceSession as JInferenceSession
from awm_tpu.config import get_config as jget_config

import torch_assets as ta
from awm_tpu_torch import bench
from awm_tpu_torch import train as tr
from awm_tpu_torch.__main__ import main as cli
from awm_tpu_torch.__main__ import parse_args
from awm_tpu_torch.api import InferenceSession
from awm_tpu_torch.checkpoint import variables_from_flax
from awm_tpu_torch.config import get_config
from awm_tpu_torch.models import build_models
from awm_tpu_torch.tools import bench_sweep, demo_eval, demo_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, B = 800, 4
TOL = 1e-4
DRILL = os.path.join(REPO, "awm_tpu_torch", "tools", "corpus_drill.sh")


def _jax_module(relpath):
    """A repo-level JAX file (bench.py, tools/*.py) as a module."""
    spec = importlib.util.spec_from_file_location("jax_" + os.path.basename(relpath)[:-3],
                                                  os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench_py_function(name):
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def test_make_clips_matches_jax_bench_and_sweep():
    """The port's make_clips (bench's and the sweep's) equals
    tools/bench_sweep.make_clips and the inline synthesis of bench.py's
    _bench_inference (its own statements, executed at audio_len=T), bit for
    bit."""
    fn = _bench_py_function("_bench_inference")
    wanted = {"rng", "t", "batch", "clips"}
    stmts = [s for s in fn.body if isinstance(s, ast.Assign)
             and {n.id for tgt in s.targets for n in ast.walk(tgt) if isinstance(n, ast.Name)} & wanted]
    ns = {"np": np, "cfg": types.SimpleNamespace(audio_len=T, sample_rate=16000)}
    exec(compile(ast.Module(body=stmts, type_ignores=[]), "bench.py", "exec"), ns)
    ours = bench.make_clips(ns["batch"], T, 16000)
    assert ours.dtype == np.float32 and ours.shape == (512, T)
    np.testing.assert_array_equal(ours, ns["clips"])
    np.testing.assert_array_equal(bench_sweep.make_clips(7, T, 16000),
                                  _jax_module("tools/bench_sweep.py").make_clips(7, T, 16000))


@pytest.fixture(scope="module")
def base_pair():
    """The JAX base preset's init_state(key(0)) at T, its fp32 session, and
    the port's fp32 session over the same tree carried across the bridge."""
    jcfg = dataclasses.replace(jget_config("base"), audio_len=T)
    state, gen, det = jtr.init_state(jcfg, jax.random.key(0))
    jsess = JInferenceSession.from_state(jcfg, gen, det, state, compute_dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("base"), audio_len=T)
    pgen, pdet = build_models(cfg.model)
    for name, net in (("gen", pgen), ("det", pdet)):
        net.load_state_dict(variables_from_flax(
            {part: ta.jax_to_np(getattr(state, part)[name]) for part in ("params", "batch_stats")}),
            strict=True)
    sess = InferenceSession(pgen, pdet, chunk_len=T, compute_dtype=torch.float32, shaping=cfg.shaping,
                            device="cpu")
    return jsess, sess, cfg


def _votes_close(got, want):
    np.testing.assert_allclose(got, want, atol=1.0 / T + 1e-7)


@pytest.mark.parametrize("call", ["_embed_detect", "_detect_reduced"])
def test_session_calls_match_jax(base_pair, call):
    """The two calls the bench times, on its clips with messages arange(B)
    and full lengths: probabilities and logit means within 1e-4, vote
    fractions within one vote."""
    jsess, sess, cfg = base_pair
    clips = bench.make_clips(B, T, cfg.sample_rate)
    lengths = np.full(B, T, np.int32)
    with torch.inference_mode():
        if call == "_embed_detect":
            want = jsess._embed_detect(jnp.asarray(clips), jnp.arange(B, dtype=jnp.int32), jnp.asarray(lengths))
            got = sess._embed_detect(torch.from_numpy(clips), torch.arange(B), torch.from_numpy(lengths).long())
            assert sorted(got) == sorted(want)
            for k in ("wm_prob", "clean_prob", "msg_logit_mean", "delta_rms"):
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=TOL, err_msg=k)
            _votes_close(got["msg_vote_frac"].numpy(), np.asarray(want["msg_vote_frac"]))
        else:
            want = jsess._detect_reduced(jnp.asarray(clips), jnp.asarray(lengths))
            got = sess._detect_reduced(torch.from_numpy(clips), torch.from_numpy(lengths).long())
            for k, g, w in zip(("probs", "msg_logit_mean", "msg_vote_frac", "mean_prob"), got, want):
                assert g.shape == w.shape, k
                if k == "msg_vote_frac":
                    _votes_close(g.numpy(), np.asarray(w))
                else:
                    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, err_msg=k)


def _bench_py_keys():
    """The keys of the dict bench.py's main prints with json.dumps."""
    fn = _bench_py_function("main")
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps")
    return [k.value for k in call.args[0].keys]


@pytest.fixture
def one_thread():
    """torch's CPU kernels on one thread.  Beside the suite's other workers an
    oversubscribed thread pool made these T=800 steps 12-45x slower (a bf16
    step at B=4 took 13 s, so train_vs_baseline rounded to 0.0)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_bench_main_prints_bench_py_keys(monkeypatch, capsys, one_thread):
    """bench.main at a small size prints one JSON line with exactly
    bench.py's seven keys after the wait for an exclusive card: the three
    rates it measured finite and positive, every printed number finite (a
    rounded rate of a slow CPU step may print as 0.0)."""
    waited, rates = [], []

    def spy(fn):
        def measured(*args):
            out = fn(*args)
            rates.extend(out if isinstance(out, tuple) else (out,))
            return out
        return measured

    monkeypatch.setattr(bench, "_wait_for_exclusive_chip", lambda: waited.append(True))
    monkeypatch.setattr(bench, "_bench_inference", spy(bench._bench_inference))
    monkeypatch.setattr(bench, "_bench_train", spy(bench._bench_train))
    out = bench.main("cpu", audio_len=T, infer_batch=B, infer_iters=1, train_batch=B, train_iters=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and waited == [True]
    assert len(rates) == 3 and all(math.isfinite(r) and r > 0 for r in rates), rates
    line = json.loads(lines[0])
    assert list(line) == _bench_py_keys() and len(line) == 7 and line == out
    numbers = {k: v for k, v in line.items() if not isinstance(v, str)}
    assert len(numbers) == 5 and all(isinstance(v, float) and math.isfinite(v) for v in numbers.values()), line
    infer, detect, train = rates
    assert (line["value"], line["detect_only_clips_per_sec_per_chip"], line["train_clips_per_sec_per_chip"]) == (
        round(infer, 1), round(detect, 1), round(train, 1))
    assert line["metric"] == "embed_detect_clips_per_sec_per_chip" and line["unit"] == "1s-16kHz clips/s"


def test_bench_command_without_card_raises(monkeypatch):
    """`python -m awm_tpu_torch bench` defaults to cuda, and with no card it
    raises before it waits or times anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "_wait_for_exclusive_chip", lambda: pytest.fail("waited"))
    assert parse_args(["bench"]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        cli(["bench"])


def _fake_proc(root, procs):
    """procs: pid -> (ppid, cmdline argv)."""
    for pid, (ppid, argv) in procs.items():
        d = root / str(pid)
        d.mkdir()
        (d / "cmdline").write_bytes(b"\0".join(a.encode() for a in argv) + b"\0")
        (d / "status").write_text(f"Name:\tx\nPid:\t{pid}\nPPid:\t{ppid}\n")
    (root / "self").mkdir()


FAMILY = {
    1: (0, ["/sbin/init"]),
    40: (1, ["timeout", "900", "bash", "-c", "python -m awm_tpu_torch bench"]),
    41: (40, ["bash", "-c", "python -m awm_tpu_torch bench"]),
    42: (41, ["python", "-m", "awm_tpu_torch", "bench"]),
    50: (1, ["python", "-m", "awm_tpu", "train"]),  # the JAX package's, not the port's
}


def test_wait_ignores_own_ancestors(tmp_path, monkeypatch):
    """The bench's own parents name the package; they are not waited for."""
    _fake_proc(tmp_path, FAMILY)
    monkeypatch.setattr(bench, "_busy_pids", functools.partial(bench._busy_pids, me=42))
    monkeypatch.setattr(time, "sleep", lambda s: pytest.fail("waited"))
    assert bench._busy_pids(str(tmp_path)) == []
    bench._wait_for_exclusive_chip(max_wait_s=60.0, proc_root=str(tmp_path))


def test_wait_for_stranger_is_bounded(tmp_path, monkeypatch, capsys):
    """A stranger that names the package makes the bench wait, and a bounded
    max_wait_s ends the wait with the original's message."""
    _fake_proc(tmp_path, {**FAMILY, 77: (1, ["python", "-m", "awm_tpu_torch", "train"])})
    monkeypatch.setattr(bench, "_busy_pids", functools.partial(bench._busy_pids, me=42))
    real_sleep, slept = time.sleep, []
    monkeypatch.setattr(time, "sleep", lambda s: (slept.append(s), real_sleep(0.02)))
    assert bench._busy_pids(str(tmp_path)) == [77]
    t0 = time.monotonic()
    bench._wait_for_exclusive_chip(max_wait_s=0.1, proc_root=str(tmp_path))
    assert time.monotonic() - t0 < 5.0
    assert slept and all(0 < s <= 0.1 for s in slept)
    err = capsys.readouterr().err
    assert "waiting for awm_tpu_torch process(es) [77]" in err and "proceeding despite" in err


@pytest.fixture(scope="module")
def small_state():
    cfg = dataclasses.replace(get_config("base"), audio_len=T)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    return cfg, tr.init_state(cfg, seed=0, device="cpu")


def _fake_step(fail_at, error):
    def step(cfg, state, s):
        if s.shape[0] == fail_at:
            raise error
        return {"total": torch.tensor(1.0)}
    return step


def test_sweep_stops_at_out_of_memory(small_state, monkeypatch, capsys):
    """A point that runs out of memory prints FAILED (OutOfMemoryError) and
    ends the sweep; the points before it keep their rates."""
    cfg, state = small_state
    monkeypatch.setattr(tr, "train_step", _fake_step(3, torch.OutOfMemoryError("out of memory")))
    rows = bench_sweep.sweep_train(cfg, state, [2, 3, 4], n_iter=1)
    out = capsys.readouterr().out.splitlines()
    assert [b for b, _ in rows] == [2] and rows[0][1] > 0
    assert out[0].startswith("train B=    2:") and out[0].endswith("clips/s")
    assert out[1:] == ["train B=    3: FAILED (OutOfMemoryError)"]


def test_sweep_raises_other_errors(small_state, monkeypatch):
    """Any other error is raised, not printed as a sweep's last line."""
    cfg, state = small_state
    monkeypatch.setattr(tr, "train_step", _fake_step(3, RuntimeError("kernel launch failed")))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        bench_sweep.sweep_train(cfg, state, [2, 3, 4], n_iter=1)


def test_sweep_writes_trace(small_state, tmp_path, capsys, one_thread):
    """--trace-dir: a torch.profiler trace of the best train point, B=2."""
    cfg, state = small_state
    rows = bench_sweep.sweep_train(cfg, state, [2], n_iter=1, trace_dir=str(tmp_path))
    assert len(rows) == 1 and rows[0][1] > 0
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert f"trace written to {tmp_path} (B=2)" in capsys.readouterr().out


DEMO_CASES = {
    "shapecap_per_bit": ["evidence/r5/shapecap/demo_eval.json", "--per-bit",
                         "evidence/r5/shapecap/per_bit.txt"],
    "shapecap_vs_flagship": ["evidence/r5/shapecap/demo_eval.json", "--vs",
                             "evidence/r5/flagship/demo_eval.json"],
    "drill_quality": ["evidence/drill/demo_eval.json"],
}


@pytest.mark.parametrize("case", sorted(DEMO_CASES))
def test_demo_table_matches_jax(case, monkeypatch, capsys):
    argv = [a if a.startswith("--") else os.path.join(REPO, a) for a in DEMO_CASES[case]]
    jax_tool = _jax_module("tools/demo_table.py")
    monkeypatch.setattr("sys.argv", ["demo_table.py", *argv])
    jax_tool.main()
    want = capsys.readouterr().out
    demo_table.main(argv)
    got = capsys.readouterr().out
    assert "### Headline" in want and got == want


def _drill_commands():
    """The drill's `python -m awm_tpu_torch...` commands, continuation lines
    joined, as argv with $D and $DEV filled in and the redirection cut."""
    with open(DRILL) as f:
        text = f.read().replace("\\\n", " ")
    cmds = []
    for line in text.splitlines():
        if line.strip().startswith("python -m awm_tpu_torch"):
            argv = shlex.split(line.replace("$DEV", "cuda").replace("$D", "/d"))
            cmds.append(argv[:argv.index(">")] if ">" in argv else argv)
    return cmds


@pytest.mark.parametrize("argv", _drill_commands(), ids=lambda a: "_".join(a[2:5]).replace("-", ""))
def test_drill_command_parses(argv):
    """Every command of the drill parses with the port's argparse."""
    assert argv[:2] == ["python", "-m"]
    if argv[2] == "awm_tpu_torch":
        args = parse_args(argv[3:])
        assert args.cmd in ("prep", "train")
        if args.cmd == "train":
            assert (args.data, args.epochs, args.batch_size, args.device) == ("/d/speech", 2, 32, "cuda")
    else:
        assert argv[2] == "awm_tpu_torch.tools.demo_eval"
        args = demo_eval.parse_args(argv[3:])
        assert (args.ckpt, args.sections, args.n_eval, args.device) == ("/d/run/ckpt_best", "quality", 64, "cuda")


def test_demo_eval_takes_dec_loss_and_ignores_it():
    """The JAX tool accepts --dec-loss and ignores it (tools/demo_eval.py:246-249):
    the r5 record's flagship demo_eval line (tools/r5_run.sh) with the
    record's own --dec-loss (its COMMON training flags) parses in the port's
    tool, and the flag changes nothing else."""
    with open(os.path.join(REPO, "tools", "r5_run.sh")) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if "tools/demo_eval.py" in ln and "variance" in ln)
    argv = shlex.split(line.split("tools/demo_eval.py", 1)[1].split(">")[0])
    dec_loss = shlex.split(text.split("COMMON=", 1)[1].splitlines()[0].strip('"'))
    dec_loss = dec_loss[dec_loss.index("--dec-loss"):][:2]
    assert dec_loss == ["--dec-loss", "mean"]
    plain, given = demo_eval.parse_args(argv), demo_eval.parse_args(argv + dec_loss)
    assert given.sections == "quality,robust,ecc,music,cross,variance" and given.dec_loss == "mean"
    assert vars(plain) == {**vars(given), "dec_loss": None}
    with pytest.raises(SystemExit):
        demo_eval.parse_args(argv + ["--dec-loss", "sum"])


def test_drill_is_the_ports():
    """Seven stages through the port; nothing of the JAX package."""
    with open(DRILL) as f:
        text = f.read()
    assert len(_drill_commands()) == 7
    assert "python -m awm_tpu " not in text and "jax" not in text.lower()
    assert "import awm_tpu." not in text and "from awm_tpu." not in text and "DRILL_DONE" in text
    # the directory it empties is the caller's or a new one, never a fixed shared path
    assert 'D=${1:-$(mktemp -d "${TMPDIR:-/tmp}/awm_corpus_drill.XXXXXX")}' in text


def test_cli_entry_does_not_import_torch():
    """`python -m awm_tpu_torch` imports torch only for a command that needs
    it: the drill's five host-only prep stages skip its import (seconds a
    process).  The module and its exit hook run here through `prep --help`;
    data/prep.py itself imports numpy and scipy only."""
    code = ("import runpy, sys\nsys.argv = ['awm_tpu_torch', 'prep', '--help']\n"
            "try:\n    runpy.run_module('awm_tpu_torch', run_name='__main__', alter_sys=True)\n"
            "except SystemExit as e:\n    assert e.code == 0, e.code\n"
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "False"
