"""Whether two trees of the port compile their kernel sources to the same
code: each kernel's SASS (`cuobjdump -sass`) and its registers and spills
(`nvcc -Xptxas -v`), on a machine with the CUDA toolkit.

    python multimodal_sequencing_tpu_torch/tools/sass_diff.py --root DIR
        [--sources NAME ...]

Compiles each source (default: the two flash-attention sources) of the
package in this checkout and of the one under DIR, such as a commit and its
parent, with this checkout's `nvcc` flags (`ops/_build.py`) into a
temporary directory, every `nvcc` at once. Prints one JSON line a source:
for each kernel, whether its SASS and its ptxas lines are equal in the two
trees, and its instruction count in each. Kernel names drop the anonymous
namespace's hash, which nvcc derives from the file. Exits 1 when a kernel
differs or is missing from one tree, or a build fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile


def _norm(text: str) -> str:
    return re.sub(r"_GLOBAL__N__[0-9a-f]{8}", "_GLOBAL__N__", text)


def _sass(tool: str, lib: str) -> dict:
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    return {_norm(fn.split()[0]): _norm(fn)
            for fn in text.split("Function : ")[1:]}


def _ptxas(log: str) -> dict:
    kernels, name = {}, None
    for line in _norm(log).splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            kernels[name] = []
        elif name and ("registers" in line or "spill" in line):
            kernels[name].append(line.strip())
    return kernels


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True,
                    help="the other tree (holds multimodal_sequencing_tpu_torch)")
    ap.add_argument("--sources", nargs="+", default=["flash_fwd", "flash_bwd"])
    args = ap.parse_args(argv)
    this = os.path.dirname(os.path.dirname(here))
    sys.path.insert(0, this)
    from multimodal_sequencing_tpu_torch.ops import _build
    try:
        nvcc = _build._nvcc()
    except RuntimeError as e:
        print(f"sass_diff: {e}", file=sys.stderr)
        return 1
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}  # every nvcc started together
        for tree, root in (("other", args.root), ("this", this)):
            for name in args.sources:
                lib = os.path.join(tmp, f"{tree}_{name}.so")
                src = os.path.join(root, "multimodal_sequencing_tpu_torch",
                                   "ops", "csrc", f"{name}.cu")
                jobs[tree, name] = (lib, subprocess.Popen(
                    [nvcc, *_build.NVCC_FLAGS, "-o", lib, src],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
        logs = {key: proc.communicate()[0] for key, (_, proc) in jobs.items()}
        failed = [key for key, (_, proc) in jobs.items() if proc.returncode]
        if failed:
            print("\n".join(logs[key] for key in failed), file=sys.stderr)
            return 1
        same_all = True
        for name in args.sources:
            a = _sass(tool, jobs["other", name][0])
            b = _sass(tool, jobs["this", name][0])
            pa, pb = _ptxas(logs["other", name]), _ptxas(logs["this", name])
            kernels = {k: {"sass_equal": a.get(k) == b.get(k),
                           "ptxas_equal": k in pa and pa.get(k) == pb.get(k),
                           "instructions": [a.get(k, "").count(";"),
                                            b.get(k, "").count(";")]}
                       for k in sorted(set(a) | set(b))}
            same_all &= all(v["sass_equal"] and v["ptxas_equal"]
                            for v in kernels.values())
            print(json.dumps({"source": name, "kernels": kernels}), flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
