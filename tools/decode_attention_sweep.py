#!/usr/bin/env python3
"""Sweep of the CUDA decode-attention kernel's ring shape and split plan on
one NVIDIA GPU.

    python3 tools/decode_attention_sweep.py [--only NAME,NAME] [--chunks 1024,4096]

Builds variants of ``src/repro_torch/kernels/csrc/decode_attention.cu``
whose ring shape per dtype (``kRingBudget*``: bytes of K/V ring per block,
which sets the blocks per SM; ``kMaxStages*``: slots per warp ring) and
copy instruction are replaced, one ``nvcc`` each, all started together: a variant with ``__expf`` in place of
``expf`` (not exact enough for f32: it only shows whether the exponentials
cost time), and variants whose copies carry an L2 prefetch size or an
evict-first policy. Each variant is called through its own C entry point at B 8 x
S 32768 (f32 and bf16) and B 128 x S 32768 (bf16), granite-3-2b heads
(H 32, Hkv 8, hd 64), full lengths, at several chunk sizes, and timed with
CUDA graphs; two passes in turns (variants forward, then backward). Every
output is held against the committed source's at the wrapper's own plan.
Prints one JSON object per line, and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

# name: (ring KB bf16, ring KB f32, max stages bf16, max stages f32, L2
# prefetch size or None, fast exp, evict first). "ring112_stages4" is the
# kernel's first ring (one ring for both dtypes, no prefetch size), the
# rows after it vary it; "committed" is the source as it is.
VARIANTS = {
    "ring112_stages4": (112, 112, 4, 4, None, False, False),
    "ring112_stages6": (112, 112, 6, 6, None, False, False),
    "ring56_stages4": (56, 56, 4, 4, None, False, False),
    "ring40_stages4": (40, 40, 4, 4, None, False, False),
    "ring150_stages8": (150, 150, 8, 8, None, False, False),
    "ring112_stages4_fastexp": (112, 112, 4, 4, None, True, False),
    "ring112_stages6_L2pf128": (112, 112, 6, 6, 128, False, False),
    "ring112_stages6_L2pf256": (112, 112, 6, 6, 256, False, False),
    "ring112_stages6_L2pf256_evict": (112, 112, 6, 6, 256, False, True),
    "ring150_stages8_L2pf256": (150, 150, 8, 8, 256, False, False),
    "committed": (150, 112, 8, 6, 256, False, False),
}
LONG_S = 32768
H, HKV, HD = 32, 8, 64


CP_ASYNC = re.compile(r"__device__ __forceinline__ void cp_async16\(.*?\n}\n", re.S)


def variant_source(src: str, kb_bf16: int, kb_f32: int, st_bf16: int, st_f32: int, prefetch,
                   fast: bool, evict: bool) -> str:
    out = src
    for name, value in (("kRingBudgetBf16", f"{kb_bf16} * 1024"), ("kRingBudgetF32", f"{kb_f32} * 1024"),
                        ("kMaxStagesBf16", st_bf16), ("kMaxStagesF32", st_f32)):
        out, n = re.subn(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};", out)
        if n != 1:
            raise RuntimeError(f"the source no longer names {name} once")
    if len(CP_ASYNC.findall(out)) != 1:
        raise RuntimeError("the source no longer has one cp_async16")
    if fast:
        out = re.sub(r"(?<![\w])expf\(", "__expf(", out)
    pf = f".L2::{prefetch}B" if prefetch else ""
    if evict:
        body = (
            "__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {\n"
            "  unsigned long long pol;\n"
            '  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\\n" : "=l"(pol));\n'
            f'  asm volatile("cp.async.cg.shared.global.L2::cache_hint{pf} [%0], [%1], 16, %2, %3;\\n"'
            ' ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0), "l"(pol) : "memory");\n}\n')
    else:
        body = (
            "__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {\n"
            f'  asm volatile("cp.async.cg.shared.global{pf} [%0], [%1], 16, %2;\\n"'
            ' ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");\n}\n')
    return CP_ASYNC.sub(lambda _: body, out)


def build_variants(build, names):
    src = (build.CSRC / "decode_attention.cu").read_text()
    nvcc = build._nvcc()
    procs = {}
    for name in names:
        spec = VARIANTS[name]
        d = os.path.join(ROOT, "build", "sweep", name)
        os.makedirs(d, exist_ok=True)
        cu = os.path.join(d, "decode_attention.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, *spec))
        so = os.path.join(d, "libdecode.so")
        cmd = [nvcc, *build.ARCH, *build.FLAGS, "-shared", "-o", so, cu]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.auxo_decode_attention.argtypes = [vp] * 6 + [ci] * 5 + [cl] * 4 + [ci, ci, ci, vp]
        lib.auxo_decode_attention.restype = ci
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import HBM_BYTES_PER_S, graph_ms, smi
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da

    names = sys.argv[sys.argv.index("--only") + 1].split(",") if "--only" in sys.argv else list(VARIANTS)
    chunk_list = ([int(c) for c in sys.argv[sys.argv.index("--chunks") + 1].split(",")]
                  if "--chunks" in sys.argv else [512, 1024, 2048, 4096])
    libs = build_variants(build, names)
    sms = da.sm_count(0)
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, dt in ((8, torch.float32), (8, torch.bfloat16), (128, torch.bfloat16)):
        q = torch.randn(B, H, HD, generator=g, device="cuda").to(dt)
        k = torch.empty(B, LONG_S, HKV, HD, dtype=dt, device="cuda")
        v = torch.empty_like(k)
        for t in (k, v):
            for b in range(B):
                t[b] = torch.randn(LONG_S, HKV, HD, generator=g, device="cuda")
        n = torch.full((B,), LONG_S, dtype=torch.int32, device="cuda")
        plan = da.plan_splits(B, HKV, LONG_S, sms, da.blocks_per_sm(0, HD, H // HKV, dt))
        chunks = sorted({plan[1], *chunk_list} if B == 8 else {LONG_S, 16384, 8192, 4096})
        want = da.decode_attention(q, k, v, n)
        nbytes = 2 * B * H * HD * q.element_size() + 2 * B * LONG_S * HKV * HD * q.element_size()
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        inner, reps = (20, 15) if B == 8 else (3, 8)
        mask = (torch.arange(LONG_S, device="cuda")[None, :] < n[:, None])[:, None, None, :]
        F = torch.nn.functional
        sdpa_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=True), inner, reps)
        print(json.dumps({"library": "sdpa", "B": B, "dtype": str(dt).split(".")[-1],
                          "ms": sdpa_ms, "bound_ms": bound}), flush=True)
        for turn, order in enumerate((list(libs), list(libs)[::-1])):
            for name in order:
                for chunk in chunks:
                    ns = math.ceil(LONG_S / chunk)
                    out = torch.empty(B, H, HD, dtype=dt, device="cuda")
                    part = torch.empty(max(1, B * HKV * ns * (H // HKV) * (HD + 2)),
                                       dtype=torch.float32, device="cuda")

                    def call():
                        err = libs[name].auxo_decode_attention(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(), n.data_ptr(),
                            out.data_ptr(), part.data_ptr(), B, H, HKV, HD, LONG_S,
                            k.stride(0), k.stride(1), v.stride(0), v.stride(1), ns,
                            chunk if ns > 1 else LONG_S, 0 if dt == torch.float32 else 1,
                            torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"{name}: cudaError {err}")

                    call()
                    torch.cuda.synchronize()
                    diff = (out.float() - want.float()).abs().max().item()
                    ms = graph_ms(torch, call, inner, reps)
                    print(json.dumps({"turn": turn, "variant": name, "B": B,
                                      "dtype": str(dt).split(".")[-1], "n_split": ns,
                                      "chunk": chunk, "ms": ms, "bound_ms": bound,
                                      "share_of_bound": bound / ms,
                                      "max_diff_vs_committed": diff}), flush=True)
        del q, k, v, want
        torch.cuda.empty_cache()
    print(smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
