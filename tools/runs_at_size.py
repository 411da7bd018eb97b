#!/usr/bin/env python3
"""The port's drivers at size on the GPU, one subcommand a run (each is a
run of its own: the human-scale set takes minutes to make and index):

  python tools/runs_at_size.py quant-window [--work DIR]
      the human-scale index (BENCH_BUILD_HS=1 python -m
      salmon_tpu_torch.bench into DIR/cache), 2,000,000 pairs from
      scripts/make_synthetic_txome.py (seed 7: the index's
      transcriptome, checked by its sequence and name hashes), then
      `python -m salmon_tpu_torch.scripts.quant_window --seconds 120` on
      them, and the stage clocks of a run of the same files to its end
  python tools/runs_at_size.py alignment [REPS]
      python -m salmon_tpu_torch.scripts.bench_alignment_mode REPS (80)
  python tools/runs_at_size.py multihost [--procs 1,2,4] [--work DIR]
      the 2,000,000 pairs made here, then python -m
      salmon_tpu_torch.scripts.bench_multihost --procs ...
      --devices-per-proc 0 on them (it indexes their transcriptome
      before its timed runs)
  python tools/runs_at_size.py sims
      python -m salmon_tpu_torch.scripts.sim_paralog_gate (the five
      settings) and python -m salmon_tpu_torch.scripts.sim_rescue_recall
  python tools/runs_at_size.py graph-step [--work DIR]
      quant-window's run, then python -m
      salmon_tpu_torch.scripts.bench_graph_step on the human-scale index
      and the cache's reads (8 batches of 4,096 a mode: the eager step
      against its CUDA graph)
  python tools/runs_at_size.py graph-post [--work DIR]
      the human-scale index and its reads (BENCH_BUILD_HS=1 python -m
      salmon_tpu_torch.bench into DIR/cache), then python -m
      salmon_tpu_torch.scripts.bench_graph_post --steps
      em,bootstrap,gibbs,bias on them: a paired --seqBias --gcBias
      quant, then each post-mapping loop eager against its CUDA graphs

DIR (--work) defaults to a new directory under the temporary directory
(TMPDIR), so that two runs never share their files. Each prints the
card's name and power limit (nvidia-smi) and, as its
last line, one JSON object of what it measured (the seconds of each
step, the harnesses' own lines), which --json-out also writes; each
step's output goes to --logs. No online version check; imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import ast
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
HS_TXPS = 200_000
HS_PAIRS = 2_000_000


def _env(**extra) -> dict:
    prev = os.environ.get("PYTHONPATH", "")
    return dict(os.environ, SALMON_NO_VERSION_CHECK="1",
                PYTHONPATH=REPO + (os.pathsep + prev if prev else ""),
                **extra)


def _run(cmd: list, log: str, **env) -> tuple[float, str]:
    """Run cmd from the repository's root with its output in `log`; its
    seconds and standard output. A failure raises."""
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                         env=_env(**env))
    sec = time.perf_counter() - t0
    with open(log, "w") as fh:
        fh.write(f"$ {' '.join(cmd)}\n{res.stdout}\n--- stderr\n"
                 f"{res.stderr}\n")
    print(f"# {os.path.basename(log)}: rc {res.returncode}, {sec:.1f} s",
          file=sys.stderr, flush=True)
    if res.returncode != 0:
        sys.stderr.write(res.stderr[-3000:])
        raise RuntimeError(f"{cmd[:4]} failed, rc {res.returncode}")
    return sec, res.stdout


def _json_lines(text: str) -> list:
    out = []
    for ln in text.splitlines():
        ln = ln.strip()
        if ln.startswith("{") and ln.endswith("}"):
            out.append(json.loads(ln))
    return out


def _quant_clocks(out_dir: str) -> dict:
    """The last `quantify clocks (s): {...}` of a quant's log."""
    clocks = None
    with open(os.path.join(out_dir, "logs", "salmon_quant.log")) as fh:
        for ln in fh:
            if "quantify clocks (s): " in ln:
                clocks = ast.literal_eval(
                    ln.split("quantify clocks (s): ", 1)[1].strip())
    return clocks


def _make_pairs(out_dir: str, logs: str) -> float:
    return _run([sys.executable, os.path.join(REPO, "scripts",
                                              "make_synthetic_txome.py"),
                 "--n-txps", str(HS_TXPS), "--n-pairs", str(HS_PAIRS),
                 "--seed", "7", "--out-dir", out_dir],
                os.path.join(logs, "make_pairs.log"))[0]


def _same_txome(fasta: str, idx: str) -> dict:
    """The FASTA's sequence and name SHA-256 (as `index` hashes them)
    against the index's info.json."""
    from salmon_tpu_torch.io.fasta import iter_fasta
    seq, name = hashlib.sha256(), hashlib.sha256()
    n = 0
    for nm, s in iter_fasta(fasta):
        seq.update(s.encode("ascii"))
        name.update(nm.encode("ascii"))
        n += 1
    with open(os.path.join(idx, "info.json")) as fh:
        info = json.load(fh)
    same = (seq.hexdigest() == info["SeqHash"]
            and name.hexdigest() == info["NameHash"]
            and n == info["num_targets"])
    if not same:
        raise RuntimeError(f"{fasta} is not the transcriptome of {idx}")
    return {"txps": n, "seq_hash": seq.hexdigest()}


def quant_window_run(args, logs: str) -> dict:
    cache = os.path.join(args.work, "cache")
    rec = {}
    sec, out = _run([sys.executable, "-m", "salmon_tpu_torch.bench"],
                    os.path.join(logs, "bench_hs.log"), BENCH_BUILD_HS="1",
                    BENCH_CACHE=cache)
    rec["bench"] = {"seconds": sec, "line": _json_lines(out)[-1]}
    pairs = os.path.join(args.work, "pairs2m")
    rec["make_pairs_seconds"] = _make_pairs(pairs, logs)
    idx = os.path.join(cache, "hs_idx")
    rec["txome"] = _same_txome(os.path.join(pairs, "txome.fasta"), idx)
    r1, r2 = (os.path.join(pairs, f"reads_{i}.fastq") for i in (1, 2))
    qw_out, qw_json = (os.path.join(args.work, n)
                       for n in ("qw", "qw.json"))
    _run([sys.executable, "-m", "salmon_tpu_torch.scripts.quant_window",
          "--index", idx, "-1", r1, "-2", r2, "--seconds",
          str(args.seconds), "--out-dir", qw_out, "--json-out", qw_json,
          "--", "--progressUpdateMs", "0"],
         os.path.join(logs, "quant_window.log"))
    with open(qw_json) as fh:
        rec["quant_window"] = json.load(fh)
    full = qw_out
    if rec["quant_window"]["timed_out"]:
        full = os.path.join(args.work, "full")
        sec, _ = _run([sys.executable, "-m", "salmon_tpu_torch", "quant",
                       "-lA", "-i", idx, "-1", r1, "-2", r2, "-o", full],
                      os.path.join(logs, "quant_full.log"))
        rec["full_run_seconds"] = sec
    rec["completed_run"] = {"from": os.path.basename(full),
                            "clocks": _quant_clocks(full)}
    with open(os.path.join(full, "aux_info", "meta_info.json")) as fh:
        meta = json.load(fh)
    rec["completed_run"].update({k: meta[k] for k in (
        "num_processed", "num_mapped", "percent_mapped")})
    return rec


def alignment_run(args, logs: str) -> dict:
    sec, out = _run([sys.executable, "-m",
                     "salmon_tpu_torch.scripts.bench_alignment_mode",
                     str(args.reps)], os.path.join(logs, "abench.log"))
    return {"reps": args.reps, "seconds": sec, "line": _json_lines(out)[-1]}


def multihost_run(args, logs: str) -> dict:
    pairs = os.path.join(args.work, "pairs2m")
    rec = {"make_pairs_seconds": _make_pairs(pairs, logs)}
    sec, out = _run([sys.executable, "-m",
                     "salmon_tpu_torch.scripts.bench_multihost", "--procs",
                     args.procs, "--devices-per-proc", "0", "--r1",
                     os.path.join(pairs, "reads_1.fastq"), "--r2",
                     os.path.join(pairs, "reads_2.fastq"), "--transcripts",
                     os.path.join(pairs, "txome.fasta")],
                    os.path.join(logs, "bench_multihost.log"))
    import torch
    rec.update({"seconds": sec, "report": _json_lines(out)[-1],
                "gpus": torch.cuda.device_count()})
    return rec


def sims_run(args, logs: str) -> dict:
    rec = {}
    for name in ("sim_paralog_gate", "sim_rescue_recall"):
        sec, out = _run([sys.executable, "-m",
                         f"salmon_tpu_torch.scripts.{name}"],
                        os.path.join(logs, f"{name}.log"))
        rec[name] = {"seconds": sec, "lines": out.strip().splitlines()}
    return rec


def graph_step_run(args, logs: str) -> dict:
    rec = quant_window_run(args, logs)
    cache = os.path.join(args.work, "cache")
    sec, out = _run([sys.executable, "-m",
                     "salmon_tpu_torch.scripts.bench_graph_step", "--index",
                     os.path.join(cache, "hs_idx"), "-1",
                     os.path.join(cache, "reads_1.fastq"), "-2",
                     os.path.join(cache, "reads_2.fastq")],
                    os.path.join(logs, "bench_graph_step.log"))
    rec["graph_step"] = {"seconds": sec, "line": _json_lines(out)[-1]}
    return rec


def graph_post_run(args, logs: str) -> dict:
    cache = os.path.join(args.work, "cache")
    sec, out = _run([sys.executable, "-m", "salmon_tpu_torch.bench"],
                    os.path.join(logs, "bench_hs.log"), BENCH_BUILD_HS="1",
                    BENCH_CACHE=cache)
    rec = {"bench": {"seconds": sec, "line": _json_lines(out)[-1]}}
    sec, out = _run([sys.executable, "-m",
                     "salmon_tpu_torch.scripts.bench_graph_post", "--index",
                     os.path.join(cache, "hs_idx"), "-1",
                     os.path.join(cache, "reads_1.fastq"), "-2",
                     os.path.join(cache, "reads_2.fastq"), "--steps",
                     "em,bootstrap,gibbs,bias"],
                    os.path.join(logs, "bench_graph_post.log"))
    rec["graph_post"] = {"seconds": sec, "line": _json_lines(out)[-1]}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python tools/runs_at_size.py")
    ap.add_argument("run", choices=("quant-window", "alignment",
                                    "multihost", "sims", "graph-step",
                                    "graph-post"))
    ap.add_argument("reps", nargs="?", type=int, default=80)
    ap.add_argument("--work", default=None,
                    help="where the runs' files go (default: a new "
                         "directory under the temporary directory)")
    ap.add_argument("--seconds", type=int, default=120)
    ap.add_argument("--procs", default="1,2,4")
    ap.add_argument("--logs", default=None,
                    help="each step's output (default: WORK/logs)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible: these runs measure the "
                         "GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    args.work = args.work or tempfile.mkdtemp(prefix="runs_at_size_")
    args.logs = args.logs or os.path.join(args.work, "logs")
    os.makedirs(args.work, exist_ok=True)
    os.makedirs(args.logs, exist_ok=True)
    run = {"quant-window": quant_window_run, "alignment": alignment_run,
           "multihost": multihost_run, "sims": sims_run,
           "graph-step": graph_step_run,
           "graph-post": graph_post_run}[args.run]
    t0 = time.perf_counter()
    rec = {"run": args.run, **run(args, args.logs),
           "total_seconds": time.perf_counter() - t0,
           "device": {"kind": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count(),
                      "nvidia_smi": smi.splitlines()}}
    text = json.dumps(rec)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            fh.write(text + "\n")
    print(f"nvidia-smi: {smi}")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
