"""The port's training campaigns (``morefusion_tpu_torch/campaigns/*.sh``).

No test trains. Each script passes ``bash -n``; each port CLI invocation
in it (continuation lines joined, the script's variables given sample
values) parses with that CLI's ``parse_args``; no script names the JAX
package, its example scripts, a JAX setting or the JAX campaigns' run
directories, and every file a script writes under ``docs/results`` carries
the ``torch_`` prefix (the JAX package's banked checkpoints and tables stay
untouched; a warm start reads them through ``warm_start``).

The control flow of r5tex, r5seg and r5ssl runs in a temporary copy of the
scripts with fake ``torchrun``, ``python``, ``sleep`` and ``git`` first on
the ``PATH``. Each fake records its argv. The fake train CLI's first run
of a directory takes the leak-budget exit as the real stack reports it
(the CLI leaves ``leak_budget_exit`` in ``--out`` and ``torchrun`` exits
1, not the worker's 42), then succeeds; the fake segmenter's first
training run fails, then succeeds. ``python -`` and ``python -c`` run the
real interpreter, so r5ssl's summary heredoc reads the fake runs'
``log.json`` and writes ``docs/results/torch_r5_ssl_ab.json`` into the
copy, never into the repository.
"""

import importlib
import json
import os
import re
import shlex
import shutil
import subprocess
import sys
import textwrap
from unittest import mock

import pytest
import torch

from morefusion_tpu_torch.cli import train as cli_train
from morefusion_tpu_torch.training import loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMPAIGNS = os.path.join(REPO, "morefusion_tpu_torch", "campaigns")
SCRIPTS = ("r5cont", "r5cont2", "r5cont3", "r5hires", "r5seg", "r5seg2",
           "r5seg3", "r5ssl", "r5tex")

# sample values of the scripts' variables
VALUES = dict(RUN="/runs/run", DATA="/data", EPOCHS="3", NPROC="1",
              WARM="docs/results/occ_best_bf16.npz",
              FGW="3.0", RUNS="/runs", name="r5ssl_arm", LOGS="/logs")

# the port CLIs each script calls, in order, with their count
CALLS = dict(
    r5cont=["campaign_guardian", "train"],
    r5cont2=["campaign_guardian", "train"],
    r5cont3=["campaign_guardian", "train"],
    r5hires=["train"],
    r5seg=["train_segmentation", "train_segmentation"],
    r5seg2=["train_segmentation", "train_segmentation"],
    r5seg3=["train_segmentation", "train_segmentation"],
    r5ssl=["pretrain_backbone", "train"],
    r5tex=["train"],
)


def _text(name):
    with open(os.path.join(CAMPAIGNS, f"{name}.sh")) as f:
        return f.read()


def _substitute(line):
    def value(m):
        var = m.group(1) or m.group(2)
        assert var in VALUES, f"no sample value for ${var}: {line}"
        return VALUES[var]

    line = line.replace('"$@"', "")
    return re.sub(r"\$\{(\w+)\}|\$(\w+)", value, line)


def _invocations(name):
    """``(cli module, argv)`` of each port CLI call in the script."""
    joined = re.sub(r"\\\n\s*", " ", _text(name))
    calls = []
    for line in joined.splitlines():
        m = re.search(r"-m morefusion_tpu_torch\.cli\.(\w+)(.*)", line)
        if m is None or line.lstrip().startswith("#"):
            continue
        args = re.split(r"\s(?:&&|\|\||>|&)(?:\s|$)", m.group(2))[0]
        calls.append((m.group(1), shlex.split(_substitute(args))))
    return calls


@pytest.mark.parametrize("name", SCRIPTS + ("_common",))
def test_bash_syntax(name):
    subprocess.run(["bash", "-n", os.path.join(CAMPAIGNS, f"{name}.sh")],
                   check=True)


@pytest.mark.parametrize("name", SCRIPTS)
def test_every_cli_call_parses(name):
    calls = _invocations(name)
    assert [c for c, _ in calls] == CALLS[name]
    for cli, argv in calls:
        module = importlib.import_module(f"morefusion_tpu_torch.cli.{cli}")
        args = module.parse_args(argv)
        if cli != "campaign_guardian":  # host only; the CLIs' default
            assert args.device == "cuda"
        if cli == "train":
            assert args.resume and args.batch_size == 16
    # the packing snippets import the port and compile
    for snippet in re.findall(r'python -c "(.*?)"\n', _text(name), re.S):
        assert "from morefusion_tpu_torch import datasets" in snippet
        compile(_substitute(snippet), name, "exec")


def _jax_runs_dir():
    """The JAX campaigns' run directory, as their r5tex script names it."""
    with open(os.path.join(REPO, "examples", "campaigns", "r5tex.sh")) as f:
        return re.search(r'RUN="\$\{1:-(.+)/r5tex\}"', f.read()).group(1)


@pytest.mark.parametrize("name", SCRIPTS + ("_common",))
def test_nothing_of_the_jax_package(name):
    text = _text(name)
    for banned in ("examples/", "JAX_", _jax_runs_dir() + "/", "jax"):
        assert banned not in text, banned
    assert not re.search(r"morefusion_tpu(?!_torch)", text)
    if name == "_common":
        return
    # every file written under docs/results is the port's own
    for path in re.findall(r"docs/results/([\w${}.]+)", text):
        assert path.startswith("torch_"), path
    for tag in re.findall(r"--tag (\S+)", text):
        assert tag.startswith("torch_"), tag
    # training goes under torchrun over NPROC cards; a warm start reads
    # through warm_start
    for cli, argv in _invocations(name):
        if "--pretrained-model" in argv:
            assert re.search(r'WARM="\$\(warm_start [\w ]+\)"', text)


def _common(tmp_path, script, env=None):
    """Run ``script`` (bash) after sourcing a copy of ``_common.sh`` whose
    repository is ``tmp_path``; returns its output."""
    camp = tmp_path / "morefusion_tpu_torch" / "campaigns"
    camp.mkdir(parents=True, exist_ok=True)
    shutil.copy(os.path.join(CAMPAIGNS, "_common.sh"), camp)
    return subprocess.run(
        ["bash", "-c", f'. "{camp}/_common.sh"; {script}'],
        capture_output=True, text=True, check=True,
        env=dict(os.environ, **(env or {}))).stdout.strip()


def test_warm_start_prefers_the_ports_bank(tmp_path):
    results = tmp_path / "docs" / "results"
    results.mkdir(parents=True)
    ws = "warm_start r5cont2 r5cont"
    assert _common(tmp_path, ws) == "docs/results/r5cont2_best_bf16.npz"
    (results / "r5cont_best_bf16.npz").touch()
    assert _common(tmp_path, ws) == "docs/results/r5cont_best_bf16.npz"
    (results / "torch_r5cont_best_bf16.npz").touch()
    assert _common(tmp_path, ws) == "docs/results/torch_r5cont_best_bf16.npz"
    (results / "r5cont2_best_bf16.npz").touch()
    assert _common(tmp_path, ws) == "docs/results/torch_r5cont_best_bf16.npz"
    (results / "torch_r5cont2_best_bf16.npz").touch()
    assert _common(tmp_path, ws) == "docs/results/torch_r5cont2_best_bf16.npz"


def test_defaults_and_the_leak_exit_code(tmp_path):
    home = str(tmp_path / "home")
    out = _common(tmp_path, 'echo "$DATA $RUNS $LOGS $NPROC"',
                  env=dict(MFTPU_DATA="/d", HOME=home, NPROC=""))
    data, runs, logs, nproc = out.split()
    assert (data, runs, logs) == ("/d", f"{home}/runs_torch", "/tmp")
    assert runs != _jax_runs_dir()
    # the cards this process sees, one at the least
    assert int(nproc) == max(torch.cuda.device_count(), 1)
    assert _common(tmp_path, 'echo "$NPROC"', env=dict(NPROC="4")) == "4"
    run = tmp_path / "run"
    run.mkdir()
    assert _common(tmp_path, f'train_code "{run}" 1') == "1"
    (run / cli_train.LEAK_EXIT_FILE).touch()
    assert _common(tmp_path, f'train_code "{run}" 1') == "42"


def test_train_cli_leaves_the_leak_exit_file(tmp_path):
    def fit(**kw):
        raise loop.LeakBudgetExit("RSS over budget")

    with mock.patch.object(loop, "fit", fit), \
            mock.patch.object(cli_train, "build_datasets",
                              lambda args: ([], None, False)), \
            pytest.raises(SystemExit) as exit_:
        cli_train.main(["--out", str(tmp_path), "--tiny", "--device", "cpu",
                        "--rss-exit-gb", "1"])
    assert exit_.value.code == 42
    assert (tmp_path / cli_train.LEAK_EXIT_FILE).exists()


# ------------------------------------------------------ stubbed control flow

FAKE = textwrap.dedent('''\
    #!{python}
    """A fake {prog}: records its argv, then acts as the campaign needs."""
    import json, os, sys

    prog, argv = {prog!r}, sys.argv[1:]
    with open(os.environ["STUB_LOG"], "a") as f:
        f.write(json.dumps(dict(prog=prog, argv=argv)) + "\\n")
    if prog == "python" and argv[:1] in (["-"], ["-c"]):
        os.execv({python!r}, [{python!r}] + argv)
    if prog in ("sleep", "git"):
        sys.exit(0)
    cli = argv[argv.index("-m") + 1].rsplit(".", 1)[1]
    out = argv[argv.index("--out") + 1]
    os.makedirs(out, exist_ok=True)
    seen = os.path.join(out, ".fake_runs")
    runs = int(open(seen).read()) if os.path.exists(seen) else 0
    open(seen, "w").write(str(runs + 1))
    mode = os.environ.get("FAKE_MODE", "")
    if cli == "train":
        if mode.startswith("fail:"):
            sys.exit(int(mode[5:]))
        if runs == 0:  # the leak-budget exit as torchrun reports it
            open(os.path.join(out, "leak_budget_exit"), "w").close()
            sys.exit(1)
        auc = 0.5 if "--pretrained-backbone" in argv else 0.4
        json.dump([dict(iteration=5, epoch=0.5,
                        **{{"main/add_or_add_s/auc": auc}}),
                   dict(iteration=10, epoch=1.0,
                        **{{"main/add_or_add_s/auc": auc + 0.1}})],
                  open(os.path.join(out, "log.json"), "w"))
    elif cli == "train_segmentation":
        if prog == "torchrun" and runs == 0:
            sys.exit(42)
        name = "per_class_nomerge" if "--no-merge" in argv else "per_class"
        json.dump({{"1": [1, 2, 3]}},
                  open(os.path.join(out, name + ".json"), "w"))
    elif cli == "pretrain_backbone":
        open(os.path.join(out, "backbone_bf16.npz"), "w").close()
        open(os.path.join(out, "log.jsonl"), "w").write(
            json.dumps(dict(step=1, val_acc=0.75)) + "\\n")
''')


def _stubbed(tmp_path, name, args=(), env=None, logs=None):
    """Run campaign ``name`` in a copy of the scripts under ``tmp_path``
    with the fakes first on the PATH and the campaign logs it waits on
    written from ``logs`` (file name -> text) -> (exit code, output, the
    fakes' calls, the copy's root)."""
    root = tmp_path / "repo"
    shutil.copytree(CAMPAIGNS, root / "morefusion_tpu_torch" / "campaigns")
    (root / "docs" / "results").mkdir(parents=True)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for prog in ("torchrun", "python", "sleep", "git"):
        path = bin_dir / prog
        path.write_text(FAKE.format(prog=prog, python=sys.executable))
        path.chmod(0o755)
    data, logs_dir = tmp_path / "data", tmp_path / "logs"
    for split in ("train_tex_s44000_packed", "train_tex_hires_s44000_packed",
                  "train_tex_hires_s45000_packed", "val_tex_packed",
                  "val_tex_hires_packed"):
        (data / split).mkdir(parents=True)
        (data / split / "scalars.npz").touch()
    logs_dir.mkdir()
    for log_name, text in (logs or {}).items():
        (logs_dir / log_name).write_text(text)
    stub_log = tmp_path / "calls.jsonl"
    proc = subprocess.run(
        ["bash", str(root / "morefusion_tpu_torch" / "campaigns" /
                     f"{name}.sh"), *args],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}",
                 STUB_LOG=str(stub_log), MFTPU_DATA=str(data),
                 MFT_RUNS=str(tmp_path / "runs"),
                 MFT_CAMPAIGN_LOGS=str(logs_dir), **(env or {})))
    calls = ([json.loads(ln) for ln in open(stub_log)]
             if stub_log.exists() else [])
    return proc.returncode, proc.stdout, calls, root


def _cli_calls(calls, cli):
    return [c for c in calls
            if f"morefusion_tpu_torch.cli.{cli}" in c["argv"]]


def _parsed(call):
    argv = call["argv"]
    module = argv[argv.index("-m") + 1]
    return importlib.import_module(module).parse_args(
        argv[argv.index("-m") + 2:])


def test_r5tex_relaunches_after_the_leak_exit(tmp_path):
    run = tmp_path / "runs" / "r5tex"
    code, out, calls, _ = _stubbed(tmp_path, "r5tex", [str(run), "1"])
    assert code == 0, out
    trains = _cli_calls(calls, "train")
    assert [c["prog"] for c in trains] == ["torchrun", "torchrun"]
    assert trains[0]["argv"] == trains[1]["argv"]
    assert trains[0]["argv"][:2] == ["--standalone", "--nproc_per_node"]
    assert int(trains[0]["argv"][2]) >= 1
    args = _parsed(trains[1])
    assert args.resume and args.epochs == 1 and args.out == str(run)
    assert args.pretrained_model == "docs/results/occ_best_bf16.npz"
    assert out.splitlines() == ["[campaign] RSS exit; relaunching with "
                                "--resume", "[campaign] training complete"]
    assert not [c for c in calls if c["prog"] == "sleep"]


def test_r5tex_with_retries_spent_exits_at_the_first_failure(tmp_path):
    code, out, calls, _ = _stubbed(tmp_path, "r5tex",
                                   env=dict(RETRIES="30", FAKE_MODE="fail:3"))
    assert code == 3
    assert out.splitlines() == ["[campaign] giving up after 31 failures"]
    assert len(_cli_calls(calls, "train")) == 1
    assert not [c for c in calls if c["prog"] == "sleep"]


def test_r5seg_retries_then_runs_the_merge_ablation(tmp_path):
    done = "[campaign] training complete\n"
    code, out, calls, root = _stubbed(
        tmp_path, "r5seg",
        logs={"torch_r5tex_campaign.log": done,
              "torch_r5hires_campaign.log": done})
    assert code == 0, out
    seg = _cli_calls(calls, "train_segmentation")
    assert [c["prog"] for c in seg] == ["torchrun", "torchrun", "python"]
    assert seg[0]["argv"] == seg[1]["argv"]
    assert _parsed(seg[0]).device == "cuda"  # the CLI's default
    ablation = _parsed(seg[2])
    assert ablation.eval_only and ablation.no_merge and ablation.use_depth
    assert ablation.device == "cuda"
    assert [c["argv"] for c in calls if c["prog"] == "sleep"] == [["120"]]
    for suffix in ("", "_nomerge"):
        assert (root / "docs" / "results" /
                f"torch_r5_seg_per_class{suffix}.json").exists()
    assert [c["argv"][0] for c in calls if c["prog"] == "git"] == [
        "add", "commit"]
    assert out.splitlines()[-1] == "[r5seg] done"


def test_r5ssl_runs_the_arms_in_order_and_writes_its_summary(tmp_path):
    code, out, calls, root = _stubbed(
        tmp_path, "r5ssl",
        logs={"torch_r5seg2_campaign.log": "[r5seg2] done\n"})
    assert code == 0, out
    runs = tmp_path / "runs"
    pre = _cli_calls(calls, "pretrain_backbone")
    assert len(pre) == 1 and _parsed(pre[0]).out == str(runs / "r5ssl_pre")
    arms = [_parsed(c) for c in _cli_calls(calls, "train")]
    assert [a.out for a in arms] == [str(runs / "r5ssl_rand")] * 2 + [
        str(runs / "r5ssl_init")] * 2
    assert [a.pretrained_backbone for a in arms] == [None, None] + [
        str(runs / "r5ssl_pre" / "backbone_bf16.npz")] * 2
    assert all(a.resume and a.pretrained_model is None for a in arms)
    with open(root / "docs" / "results" / "torch_r5_ssl_ab.json") as f:
        ab = json.load(f)
    assert ab["pretext_val_acc"] == 0.75
    assert ab["random_init"]["best_auc"] == pytest.approx(0.5)
    assert ab["ssl_init"]["best_auc"] == pytest.approx(0.6)
    assert not os.path.exists(os.path.join(
        REPO, "docs", "results", "torch_r5_ssl_ab.json"))
    assert [c["argv"][0] for c in calls if c["prog"] == "git"] == [
        "add", "commit"]
    assert out.splitlines()[-1] == "[r5ssl] done"
