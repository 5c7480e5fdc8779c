"""Measures the scratch that the card's softmax backward holds beyond its
result, for each of its two operands contiguous or not: the numbers behind
``utils/hlo._SCRATCH``, whose rule it prints beside each reading.

    python3 tools/softmax_scratch.py [--shape 16,8,512,5,4096]

The default shape is the attention block of llama4-maverick-400b-a17b's
``train_4k`` step on one card (float32, 5.37 GB a tensor). A non-contiguous
operand is a transposed view of a contiguous copy. Each reading is
``max_memory_allocated``'s growth during one
``aten._softmax_backward_data`` less its result's bytes.
"""
import argparse
import json
import math
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="16,8,512,5,4096")
    args = ap.parse_args(argv)
    import torch

    from repro_torch.utils import hlo

    if not torch.cuda.is_available():
        print("softmax_scratch: no CUDA card", file=sys.stderr)
        return 1
    shape = tuple(int(s) for s in args.shape.split(","))
    nbytes = math.prod(shape) * 4

    def operand(transposed: bool):
        x = torch.rand(shape, device="cuda")
        return x.transpose(0, 1).contiguous().transpose(0, 1) if transposed else x

    rows = []
    for grad_t, out_t in ((False, False), (True, False), (False, True), (True, True)):
        grad, out = operand(grad_t), operand(out_t)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        r = torch.ops.aten._softmax_backward_data(grad, out, -1, torch.float32)
        torch.cuda.synchronize()
        scratch = torch.cuda.max_memory_allocated() - before - r.numel() * r.element_size()
        rows.append({"grad_contiguous": not grad_t, "output_contiguous": not out_t, "scratch_bytes": scratch,
                     "scratch_tensors": scratch / nbytes, "rule_bytes": hlo._softmax_backward_scratch(grad, out)})
        print(json.dumps(rows[-1]), flush=True)
        del grad, out, r
        torch.cuda.empty_cache()
    print(json.dumps({"shape": shape, "tensor_bytes": nbytes, "torch": torch.__version__,
                      "rule_holds": all(r["scratch_bytes"] == r["rule_bytes"] for r in rows)}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
