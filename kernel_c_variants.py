#!/usr/bin/env python3
"""Kernel C's design against variants that each undo one of its choices,
on the card, at phase 3's shapes of ``chip_smoke.py`` (view 0 of its
slice scene at 1280x960 with a random init: its three pairs at one
candidate and on the stack of eight propagation candidates; the
operating point's ten pairs at one candidate):

    python3 kernel_c_variants.py [--json PATH]

Each variant is built from ``hcmvs_tpu_torch/kernels/csrc/rect_lookup.cu``
by a textual edit (the script fails if the source no longer holds the
text it edits) into its own library under ``kernels/_build/variants/``:

  views_on_grid  a block a (view, tile, group of candidates): the views
                 on grid z, as the earlier design has them, so the
                 stack's sigma is read once a view;
  scalar         the same threads with 4-byte loads and stores only;
  atomics        each tile's column base from a shared-memory atomicMin
                 of its 1,024 pixels, three barriers a candidate, as the
                 earlier design takes it;
  gather_fenced  a compiler barrier before each chunk's gathers, so none
                 moves above the stores of the chunk before;
  gather_N       the gathers of N candidates (of a group of up to 8)
                 issued before their stores, for each N the source does
                 not ship (1, 2, 4, 8);
  gather_N_two_blocks  the same at most 128 registers a thread
                 (``__launch_bounds__(256, 2)``), for every N.

The earlier design (``csrc/earlier/rect_lookup.cu``) is timed beside
them, through ``kernels.earlier_designs()``.  Every design is held
bit-equal to the plain version, then timed with ``chip_smoke.cuda_ms``,
the shipped design first and last.  Prints one line a (shape, design),
the card's name and power limit, and a JSON line (also written to
``--json``).  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import sys
import time
from pathlib import Path

import chip_smoke as cs

SOURCE = "rect_lookup.cu"
VARIANTS = {
    "views_on_grid": [
        ("  const int g0 = blockIdx.z * G;",
         "  const int g0 = blockIdx.z / nv * G;"),
        ("  for (int v = 0; v < nv; ++v) {",
         "  for (int v = blockIdx.z % nv; v < blockIdx.z % nv + 1; ++v) {"),
        ("(h + kTileRows - 1) / kTileRows, n_groups);",
         "(h + kTileRows - 1) / kTileRows, n_groups * v);")],
    "scalar": [
        ("  const bool vec_ok = w % kPix == 0 &&",
         "  const bool vec_ok = false && w % kPix == 0 &&")],
    "atomics": [
        ("  __shared__ __align__(16) int s_min[2][G][kWarps];\n",
         "  __shared__ __align__(16) int s_min[2][G][kWarps];\n"
         "  __shared__ int s_one;\n"
         "  if (threadIdx.x == 0) s_one = kInvalid;\n"
         "  __syncthreads();\n"),
        ("        m = min(m, (ic < 0 || ic > w_r - 1) ? kInvalid : ic);\n"
         "      }\n"
         "      m = __reduce_min_sync(0xffffffffu, m);\n"
         "      if (lane == 0) s_min[buf][g][warp] = m;\n",
         "        atomicMin(&s_one, (ic < 0 || ic > w_r - 1) ? kInvalid"
         " : ic);\n"
         "      }\n"
         "      __syncthreads();\n"
         "      if (threadIdx.x < kWarps) s_min[buf][g][threadIdx.x] = "
         "min(s_one, m);\n"
         "      __syncthreads();\n"
         "      if (threadIdx.x == 0) s_one = kInvalid;\n"
         "      __syncthreads();\n")],
    # the gathers of a chunk not moved above the stores of the one before
    "gather_fenced": [
        ("        unsigned val[kGatherOf<G>][kChanStep][kPix];\n",
         "        asm volatile(\"\" ::: \"memory\");\n"
         "        unsigned val[kGatherOf<G>][kChanStep][kPix];\n")],
}
# candidates whose gathers are all issued before their stores (more loads
# in flight a thread, more registers), each count with and without a cap
# of 128 registers a thread (two blocks an SM)
GATHER = re.compile(r"constexpr int kGather = (\d+);")
BOUNDS = ("__global__ void __launch_bounds__(kThreads)",
          "__global__ void __launch_bounds__(kThreads, 2)")


def gather_variants(src: str) -> dict:
    """{name: edits} of every other gather count and of the register
    cap."""
    shipped = int(GATHER.search(src).group(1))
    out = {}
    for n in (1, 2, 4, 8):
        edit = (f"constexpr int kGather = {shipped};",
                f"constexpr int kGather = {n};")
        if n != shipped:
            out[f"gather_{n}"] = [edit]
        out[f"gather_{n}_two_blocks"] = [edit, BOUNDS]
    return out


def variant_sources() -> dict:
    """{name: source text} of every variant."""
    from hcmvs_tpu_torch import kernels
    src = (kernels.CSRC / SOURCE).read_text()
    out = {}
    for name, edits in {**VARIANTS, **gather_variants(src)}.items():
        text = src
        for old, new in edits:
            if old != new and text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {SOURCE} "
                                   "exactly once")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants() -> dict:
    """{name: loaded library}, one nvcc per variant, all started
    together; prints each kernel's registers and spills."""
    from hcmvs_tpu_torch import kernels
    out_dir = kernels.BUILD_ROOT / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    log = out_dir / "build.log"
    log.write_text("")
    paths, cmds = {}, []
    for name, text in variant_sources().items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        paths[name] = out_dir / f"lib{name}.so"
        cmds.append([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                     str(kernels.CSRC), "-shared", "-o", str(paths[name]),
                     str(src)])
    kernels._run_all(cmds, log)
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            cs.log(f"[build] {line.strip()}")
    return {name: kernels._load(p) for name, p in paths.items()}


@contextlib.contextmanager
def design(name: str, libs: dict):
    """Inside this block ``kernels.rect_lookup`` launches design
    ``name``: "shipped", "earlier" or a variant."""
    from hcmvs_tpu_torch import kernels
    if name == "earlier":
        with kernels.earlier_designs():
            yield
        return
    lib = kernels.library()
    kernels._state["lib"] = libs.get(name, lib)
    try:
        yield
    finally:
        kernels._state["lib"] = lib


def cases(dev):
    """[(label, rect context, sigma)] at phase 3's shapes."""
    import torch
    from hcmvs_tpu_torch.dense.scene_driver import init_scene_state
    from hcmvs_tpu_torch.dense.types import make_view_geometry, pixel_rays
    from hcmvs_tpu_torch.ops import rect_gather as rg
    out = []
    for label, scene in (("slice", cs.make_scene(dev)[1]),
                         ("operating point", cs.op_scene(cs.H, cs.W, dev)[1])):
        nbr = scene.nbr_idx[0]
        geom = make_view_geometry(scene.cams[0], scene.cams[nbr])
        st = init_scene_state(torch.Generator(device=dev).manual_seed(2),
                              scene)
        ctx = rg.build_rect_context(geom, rg.pack_depth_normals(
            st.depth[nbr], st.normal[nbr]))
        out.append((label, ctx, (1.0 / st.depth[0]).contiguous()))
        if label == "slice":
            rays = pixel_rays(geom.K_inv_ref, cs.H, cs.W)
            stack = cs.propagation_stack(st, rays, cs.slice_cfg())[0]
            out.append((f"slice, {stack.shape[0]} candidates", ctx,
                        (1.0 / stack).contiguous()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None, help="also write the results "
                    "here")
    args = ap.parse_args(argv)
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.ops import rect_gather as rg
    if not torch.cuda.is_available():
        print("kernel_c_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = cs.smi_line()
    t0 = time.perf_counter()
    kernels.library()
    kernels.earlier_library()
    libs = build_variants()
    cs.log(f"[build] {len(libs)} variants and both designs in "
           f"{time.perf_counter() - t0:.1f} s")
    order = ["shipped", "earlier", *libs, "shipped"]
    results = []
    for label, ctx, sigma in cases(dev):
        c_args = (ctx.maps, ctx.row_int, ctx.c0, ctx.k, ctx.rb, sigma)
        plain = rg.rect_lookup_plain(ctx, sigma).view(torch.int32)
        b_ms, b_by = cs.bound("rect_lookup", cs.nbytes(*c_args[1:], plain)
                              + cs.rect_rows_bytes(ctx.maps, ctx.rb,
                                                   rg.BAND_ROWS),
                              plain[..., 0, :, :].numel())
        for name in order:
            with design(name, libs):
                out = kernels.rect_lookup(*c_args)
                same = torch.equal(out.view(torch.int32), plain)
                ms = cs.cuda_ms(lambda: kernels.rect_lookup(*c_args), 20)
            results.append({"shape": list(out.shape), "field": label,
                            "design": name, "bit_equal": same, "ms": ms,
                            "bound_ms": b_ms, "bound_by": b_by})
            cs.log(f"[variants] C {label} {tuple(out.shape)} {name}: "
                   f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                   f"{100 * b_ms / ms:.1f}% of the bound, bit-equal to the "
                   f"plain version {same}")
            if not same:
                raise AssertionError(f"{name} differs from the plain version "
                                     f"on {label}")
        del ctx, sigma, plain, out
        torch.cuda.empty_cache()
    cs.log(smi)
    line = json.dumps({"device": smi, "variants": results})
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
