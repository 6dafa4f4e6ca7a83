"""Assemble SCALING.json: CPU virtual-mesh tracks + one-GPU point.

Runs the full weak-scaling harness (benchmarks/scaling.py) in a CPU child —
its three tracks (shard_map sweep, process-parallel, jax.distributed
2-process with the psum payload sweep) only make sense on the virtual mesh —
then measures the same EM iteration on the default backend's first device
(a GPU) and records it as ``gpu_single_card``.

    python benchmarks/make_scaling_artifact.py
"""
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "SCALING.json"


def main():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    print("# running CPU weak-scaling tracks (this takes a while)",
          file=sys.stderr, flush=True)
    cpu = subprocess.run(
        [sys.executable, str(REPO / "benchmarks" / "scaling.py")],
        env=env, capture_output=True, text=True, timeout=7200,
    )
    if cpu.returncode != 0:
        raise SystemExit(f"CPU scaling run failed:\n{cpu.stderr[-3000:]}")
    out = json.loads(cpu.stdout.strip().splitlines()[-1])

    print("# running the one-GPU point", file=sys.stderr, flush=True)
    gpu_env = dict(os.environ)
    gpu_env.pop("JAX_PLATFORMS", None)
    gpu_env.pop("XLA_FLAGS", None)
    gpu = subprocess.run(
        [sys.executable, str(REPO / "benchmarks" / "scaling.py"), "--one", "1"],
        env=gpu_env, capture_output=True, text=True, timeout=3600,
    )
    if gpu.returncode == 0:
        point = json.loads(gpu.stdout.strip().splitlines()[-1])
        point["note"] = (
            "same harness on one card (python benchmarks/scaling.py --one 1 "
            "with the default backend); the multi-device sweep above runs on "
            "the CPU virtual-mesh tracks"
        )
        out["gpu_single_card"] = point
    else:
        out["gpu_single_card"] = {"error": gpu.stderr[-500:]}

    commit = subprocess.run(
        ["git", "rev-parse", "HEAD"], cwd=str(REPO),
        capture_output=True, text=True,
    ).stdout.strip()
    out["generated"] = {"commit": commit,
                        "via": "python benchmarks/make_scaling_artifact.py"}
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({"written": str(OUT.name),
                      "tracks": sorted(out.keys())}))


if __name__ == "__main__":
    main()
