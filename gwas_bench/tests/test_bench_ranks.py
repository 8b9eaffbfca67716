"""A multi-card cell through the launcher, on the CPU: two gloo ranks
(``cpu_rank.py``) run the shrunken ``ukb_synth_50k.mesh4`` cell.  The
result line keeps its schema, the table is judged correct and equals the
one-process table of the same seed, both ranks make the same window calls,
a rank killed in the window ends the run within a minute, planted faults
(the exchange between cards left out among them) come out not correct,
and a one-card cell starts no process and no process group."""

import ast
import json
import math
import re
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, SEED, small
from gwas_bench import harness, launch, ranks, spec

CELL = "ukb_synth_50k.mesh4"
RANKS = 2


def _launch(tmp_path, seconds, trace=0, *extra, timeout=600):
    """The launcher in a process of its own over ``RANKS`` CPU ranks:
    (exit code, stdout, stderr, seconds it took)."""
    cmd = [sys.executable, str(ROOT / "gwas_bench" / "tests" / "cpu_rank.py"),
           "--workload", CELL, "--seed", str(SEED), "--seconds",
           str(seconds), "--trace", str(trace), "--ranks", str(RANKS), *extra]
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from gwas_bench import launch\n"
            f"sys.exit(launch.launch({cmd!r}, {RANKS}, "
            "launch.process_start()))\n")
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr, time.time() - t0


@pytest.fixture(scope="module")
def untraced(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("untraced"), 1.0)


def _line(out):
    return json.loads(out.strip().splitlines()[-1])


def _windows(err):
    """rank -> (its window's calls, its table digests), from the ranks'
    ``window:`` lines (rank 0's unprefixed)."""
    found = {}
    for m in re.finditer(r"^(?:rank (\d+): )?window: (\d+) calls, .*"
                         r"table digests (\[.*\])$", err, re.M):
        found[int(m[1] or 0)] = (int(m[2]), ast.literal_eval(m[3]))
    return found


def _number(x):
    return isinstance(x, (int, float)) and not isinstance(x, bool) \
        and math.isfinite(x)


def test_result_line_schema(untraced):
    rc, out, err, _ = untraced
    assert rc == 0, err[-3000:]
    line = _line(out)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    cell = spec.load_cell(CELL)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(_number(m["value"]) and m["unit"]
               for m in line["metrics"].values())
    dev = line["device"]
    assert dev["count"] == RANKS and _number(dev["memory_peak_bytes"])
    assert line["attempted"] % small(cell).config["p"] == 0
    # the checks are the launcher's last lines on stderr too
    tail = err.strip().splitlines()[-len(line["checks"]) - 1:]
    assert tail[-1] == "correct True"
    assert [t.split()[1] for t in tail[:-1]] == list(line["checks"])


def test_table_is_judged_correct(untraced):
    rc, out, err, _ = untraced
    line = _line(out)
    assert line["correct"] is True and line["failed"] == 0
    assert line["checks"]["rank_mismatch"] == {"value": 0.0, "limit": 0}


def test_table_equals_the_one_rank_table(untraced):
    """Rank 0's tables are the one-process table of the same seed, bit for
    bit (both at the ranks' two threads)."""
    from gwas_bench import cohorts as gen

    _, _, err, _ = untraced
    digests = _windows(err)[0][1]
    cell = small(spec.load_cell("ukb_synth_50k.scan"))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cohorts = gen.make_cohorts(cell.config, cell.traffic, SEED, "cpu")
        table = harness.Program(cell.config, cohorts,
                                torch.device("cpu")).call(0)
    finally:
        torch.set_num_threads(threads)
    assert set(digests) == {ranks.table_digest(table)}


def test_ranks_make_the_same_window_calls(untraced):
    _, out, err, _ = untraced
    seen = _windows(err)
    assert set(seen) == set(range(RANKS))
    counts = {calls for calls, _ in seen.values()}
    assert len(counts) == 1
    assert _line(out)["attempted"] == counts.pop() * \
        small(spec.load_cell(CELL)).config["p"]
    assert len({tuple(d) for _, d in seen.values()}) == 1


def test_traced_ranks_read_their_metrics(tmp_path):
    rc, out, err, _ = _launch(tmp_path, 1.0, 1)
    assert rc == 0, err[-3000:]
    line = _line(out)
    assert line["correct"] is True
    got = line["metrics"]
    # the device-marker metrics read nothing on the CPU
    for name in ("gather_ms.mesh4", "rank_skew.mesh4", "reml_ms.scan",
                 "stream_wait_ms.scan"):
        assert _number(got[name]["value"]) and got[name]["value"] >= 0, name
    assert set(got) <= {m["name"] for m in spec.load_cell(CELL).per_layer}
    assert {"busy_s", "window_s"} <= set(line["device"])


def test_killed_rank_ends_the_run(tmp_path):
    """Rank 1 dies in its second window call: the launcher ends rank 0,
    which waits in the next collective, and exits non-zero with no result
    within a minute."""
    stamp = tmp_path / "killed_at"
    rc, out, err, took = _launch(tmp_path, 30.0, 0, "--kill-in-window",
                                 str(stamp), timeout=300)
    ended = time.time()
    assert rc != 0
    assert out.strip() == ""
    assert "rank 1 exited with -9" in err
    assert ended - float(stamp.read_text()) < 60


@pytest.mark.parametrize("fault", ["no_exchange", "half_block",
                                   "stuck_lambda", "altered_beta", "ml_tau"])
def test_fault_is_refused(tmp_path, fault):
    rc, out, err, _ = _launch(tmp_path, 0.05, 0, "--fault", fault)
    assert rc == 0, err[-3000:]
    line = _line(out)
    assert line["correct"] is False, line["checks"]
    if fault == "no_exchange":
        assert line["checks"]["rank_mismatch"]["value"] > 0


def test_one_card_cell_starts_no_process_or_group(small_cell, monkeypatch):
    import torch.distributed as dist

    def refuse(*args, **kwargs):
        raise AssertionError("a one-card cell started a process or group")

    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(dist, "new_group", refuse)
    monkeypatch.setattr(launch, "launch", refuse)
    name = "ukb_synth_50k.scan"
    res = harness.run(name, SEED, 0.05, False, "cpu", small_cell(name),
                      log=lambda s: None)
    assert res["correct"] and res["device"]["count"] == 1
    assert not dist.is_initialized()


def test_run_py_launches_only_multi_card_cells():
    """``run.py``'s entry runs a one-card cell in its own process and hands
    a four-card cell to the launcher (the card and the run are stubbed)."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import torch\n"
        "from gwas_bench import harness, launch, run\n"
        "torch.cuda.is_available = lambda: True\n"
        "torch.cuda.device_count = lambda: 4\n"
        "seen = []\n"
        "launch.launch = lambda cmd, world, started: seen.append(world) or 0\n"
        "harness.run = lambda *a, **k: seen.append(a[0]) or "
        "{'checks': {}, 'correct': True}\n"
        "for cell in ('wtccc_dense_10k.scan', 'ukb_synth_50k.mesh4'):\n"
        "    sys.argv = ['run.py', '--workload', cell, '--seed', '1',\n"
        "                '--seconds', '1']\n"
        "    assert run.main() == 0\n"
        "print(json.dumps(seen))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == \
        ["wtccc_dense_10k.scan", 4]


def test_launcher_imports_nothing_of_the_program():
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from gwas_bench import launch, run\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('torch', 'numpy', 'pygemma_tpu_torch')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]"
