"""Measure the card's peak operation rates that benchmark/work/peaks.json
takes its ``ops_per_s`` from (peak_ops.cu says how), and show that each
timed kernel holds the instruction it times.

    python3 benchmark/work/peak_ops.py [--out DIR] [--iters N]

builds peak_ops.cu with nvcc into DIR (default build/peak_ops in the
checkout), runs it on card 0, then prints, for each of its kernels, how
many times each integer and FMA instruction of interest appears in its
SASS (cuobjdump).  No benchmark run reads this: it is for whoever sets or
checks a card's entry in peaks.json.
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
OPCODES = ("VIMNMX3", "VIADDMNMX", "VIMNMX", "IMNMX", "VIADD", "IADD3",
           "IMAD", "HADD2", "HMNMX2", "FFMA", "PRMT", "LOP3")


def nvcc() -> str:
    found = shutil.which("nvcc")
    return found or "/usr/local/cuda/bin/nvcc"


def sass_counts(binary: Path) -> dict[str, dict[str, int]]:
    """Each kernel's count of every opcode in OPCODES."""
    text = subprocess.run([str(Path(nvcc()).with_name("cuobjdump")),
                           "-sass", str(binary)], capture_output=True,
                          text=True, check=True).stdout
    counts: dict[str, collections.Counter] = {}
    kernel = None
    for line in text.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip()
            counts[kernel] = collections.Counter()
        elif kernel is not None:
            m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
            if m and m.group(1) in OPCODES:
                counts[kernel][m.group(1)] += 1
    return {k: dict(v) for k, v in counts.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path,
                    default=HERE.parents[1] / "build" / "peak_ops")
    ap.add_argument("--iters", type=int, default=20000)
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    binary = args.out / "peak_ops"
    subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", str(binary), str(HERE / "peak_ops.cu")],
                   check=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"], capture_output=True,
        text=True, check=True).stdout.strip()
    print("nvidia-smi:", smi)
    mhz = smi.split(",")[-1].strip()
    subprocess.run([str(binary), str(args.iters), mhz], check=True)
    for kernel, counts in sass_counts(binary).items():
        print(kernel, counts)


if __name__ == "__main__":
    main()
