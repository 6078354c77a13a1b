"""The service's concurrency test, run again and again on a saturated CPU.

    JAX_PLATFORMS=cpu python tests/torch_serve_stress.py [--tree DIR] \
        [--rounds 12] [--parallel 3] [--burners 5]

Starts ``--burners`` processes that multiply float32 matrices with torch's
full thread pool (the load of the parallel test workers, and more), then
runs ``tests/test_torch_serve.py -k one_at_a_time`` in ``--tree`` (default:
this checkout; pass an unpacked older tree to compare) ``--parallel`` at a
time for ``--rounds`` rounds, and stops the burners. Prints one JSON line:
the runs, the failures and the last error line of each failed run. Not
collected by pytest.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BURN = (
    "import time, torch\n"
    "a = torch.randn(1500, 1500)\n"
    "t = time.time()\n"
    "while time.time() - t < {seconds}:\n"
    "    a = (a @ a).clamp(-1, 1)\n"
)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--tree", default=ROOT)
    p.add_argument("--rounds", type=int, default=12)
    p.add_argument("--parallel", type=int, default=3)
    p.add_argument("--burners", type=int, default=5)
    p.add_argument("--seconds", type=float, default=3600.0,
                   help="longest a burner runs, should this script die")
    args = p.parse_args()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    burners = [subprocess.Popen(
        [sys.executable, "-c", BURN.format(seconds=args.seconds)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for _ in range(args.burners)]
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
           "tests/test_torch_serve.py", "-k", "one_at_a_time", "-x"]
    runs, failed = 0, []
    t0 = time.time()
    try:
        for _ in range(args.rounds):
            procs = [subprocess.Popen(cmd, cwd=args.tree, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for _ in range(args.parallel)]
            for proc in procs:
                out, _ = proc.communicate(timeout=600)
                runs += 1
                if proc.returncode != 0:
                    errors = [ln for ln in out.splitlines()
                              if ln.startswith("E ")]
                    failed.append(errors[-1] if errors else
                                  f"rc {proc.returncode}")
    finally:
        for b in burners:
            b.kill()
            b.wait()
    print(json.dumps({"tree": os.path.abspath(args.tree), "runs": runs,
                      "failed": len(failed), "errors": failed,
                      "burners": args.burners, "parallel": args.parallel,
                      "seconds": round(time.time() - t0, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
