"""Human-scale accuracy run: quantify the synthetic 200,000-transcript
reads with this package's CLI and score NumReads against the read-name
truth (names encode readnum:txp:fragstart:fraglen).

Counterpart of scripts/eval_hs_accuracy.py.

Usage: python -m salmon_tpu_torch.scripts.eval_hs_accuracy [out_dir]
Env: BENCH_CACHE (hs_idx and reads; default ~/.cache/salmon_tpu_bench)
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from collections import Counter

import numpy as np

from salmon_tpu_torch.scripts import REPO, cache_dir, require_device

# the CLI on a device the caller names (python -m salmon_tpu_torch takes
# the GPU)
_CLI_ON = ("import sys; from salmon_tpu_torch.cli import main; "
           "sys.exit(main(sys.argv[1:], device={!r}))")


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    device = require_device(device, "eval_hs_accuracy")
    cache = cache_dir()
    out = argv[0] if argv else os.path.join(tempfile.gettempdir(),
                                            "hs_quant")
    r1 = os.path.join(cache, "reads_1.fastq")
    r2 = os.path.join(cache, "reads_2.fastq")
    idx = os.path.join(cache, "hs_idx")
    prev = os.environ.get("PYTHONPATH", "")
    env = dict(os.environ, SALMON_NO_VERSION_CHECK="1",
               PYTHONPATH=REPO + (os.pathsep + prev if prev else ""))
    prog = (["-m", "salmon_tpu_torch"] if device.type == "cuda"
            else ["-c", _CLI_ON.format(str(device))])
    cmd = [sys.executable, *prog, "quant", "-i", idx, "-l", "IU", "-1", r1,
           "-2", r2, "-o", out]
    print("#", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, env=env, cwd=REPO)

    truth = Counter()
    with open(r1) as fh:
        for i, ln in enumerate(fh):
            if i % 4 == 0:
                truth[ln[1:].split(":")[1]] += 1
    est = {}
    with open(os.path.join(out, "quant.sf")) as fh:
        next(fh)
        for ln in fh:
            f = ln.split("\t")
            est[f[0]] = float(f[4])
    names = sorted(est)
    t = np.array([truth.get(n, 0) for n in names], float)
    e = np.array([est[n] for n in names], float)
    from scipy.stats import pearsonr, spearmanr
    expressed = (t > 0) | (e > 0)
    rho_all = spearmanr(t, e).statistic
    rho_exp = spearmanr(t[expressed], e[expressed]).statistic
    r = pearsonr(np.log1p(t), np.log1p(e)).statistic
    print(f"txps={len(names)} expressed={int(expressed.sum())} "
          f"truth_frags={int(t.sum())} est_frags={e.sum():.0f}")
    print(f"Spearman(all)={rho_all:.5f} Spearman(expressed)={rho_exp:.5f} "
          f"Pearson(log)={r:.5f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
