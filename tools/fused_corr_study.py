#!/usr/bin/env python3
"""Times builds of the fused correspondence kernel against each other on
one NVIDIA GPU, in one process: this checkout's `fused_corr.cu`, variants
of it, and optionally another checkout's (the parent tree).

    python3 tools/fused_corr_study.py [--parent DIR] [--sweep] [--out FILE]

- Every build is nvcc of one source with the flags of
  `lio_slam_tpu_torch/ops/_build.py` into `build/fused_corr_study/`, all
  started together; ptxas's register report of each is printed.
- The scenes are `chip_smoke.py`'s phase 2 and 20 (a)
  (`chip_smoke.kernel_scene`): its 8192-point scan and 65536-point map in
  grids of 32768 buckets at "xy"/72, "full"/128, "z"/24 and "none"/24, at
  its pose.
- Each build is first held to the plain version on each scene (inliers
  exact, AtA / Atb within rtol 2e-4 / atol 2e-3; builds that take the
  grid's counts also bit-equal with and without them), then timed: the
  kernel's own launch in torch.profiler (`chip_smoke.named_kernel_ms`),
  warm and with a cold L2.
- `--parent DIR`: DIR holds another checkout (`git archive` of the parent
  commit); its source is built too (its launcher takes no counts) and the
  two are timed in turns, parent, this, this, parent, at every scene.
- Each scene also times this source on whole rows (`counts=None`) and its
  launch floor (`lio_fused_corr_floor`).
- `--sweep`: variants of this source (lanes a point and warps a block),
  each timed beside this source in turns, this, variants..., this, at
  "xy"/72 and "full"/128, with and without counts.
Prints the card's name and power limit first and a JSON summary last (also
written to FILE, `build/fused_corr_study/results.json` by default).  Needs a
CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "lio_slam_tpu_torch", "ops", "csrc",
                      "fused_corr.cu")
OUT_DIR = os.path.join(ROOT, "build", "fused_corr_study")
SCENES = (("xy", 72), ("full", 128), ("z", 24), ("none", 24))
# (name, {constant: value}) of the variants: lanes a point and warps a
# block (the sweep times them at 1 and 3 ids a point)
SWEEP = tuple((f"lanes{ln}_warps{w}", {"LANES": ln, "WARPS": w})
              for ln in (4, 8, 16) for w in (8, 16) if (ln, w) != (8, 16))


def variant_source(subs: dict) -> str:
    """This source with the constants in `subs` replaced."""
    s = open(SOURCE).read()
    for name, value in subs.items():
        s, n = re.subn(r"(constexpr int %s = )[^;]+;" % name,
                       r"\g<1>%s;" % value, s)
        if n != 1:
            raise RuntimeError(f"the kernel source lost the constant {name}")
    return s


def build(name: str, source_text: str):
    """(name, library path, ptxas report lines) of one nvcc build."""
    from lio_slam_tpu_torch.ops import _build

    src = os.path.join(OUT_DIR, f"{name}.cu")
    so = os.path.join(OUT_DIR, f"lib{name}.so")
    with open(src, "w") as f:
        f.write(source_text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
              if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return name, so, report


class Kernel:
    """One build, bound through ctypes: this tree's source and its variants
    as `_build` binds the library; a build without the launch floor (the
    parent tree's, PR 12) has the older launcher, without counts."""

    def __init__(self, name, so, dev):
        import torch

        from lio_slam_tpu_torch.ops import _build

        self.name = name
        self.lib = ctypes.CDLL(so)
        self.takes_counts = hasattr(self.lib, "lio_fused_corr_floor")
        if self.takes_counts:
            _build.bind_fused_corr(self.lib)
        else:
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            self.lib.lio_fused_corr.argtypes = [vp, ci, ci, vp, ci, vp, vp, ci,
                                                vp, cf, cf, cf, vp, ci, vp, vp]
            self.lib.lio_fused_corr.restype = ci
            self.lib.lio_fused_corr_scratch_floats.restype = ci
            self.lib.lio_fused_corr_block_warps.argtypes = [ci, ci]
            self.lib.lio_fused_corr_block_warps.restype = ci
        self.scratch = torch.zeros(self.lib.lio_fused_corr_scratch_floats(),
                                   dtype=torch.float32, device=dev)

    def launcher(self, table, hh, scan, mask, pose, counts, kw, floor=False):
        """A no-argument function that launches on these inputs (`floor`:
        the launch's fixed chain alone) and returns the output words as the
        wrapper's five views."""
        import torch

        from lio_slam_tpu_torch.ops import fused_corr as fc

        T, C, _ = table.shape
        O, N = hh.shape
        out = torch.empty(fc.OUT_WORDS, dtype=torch.float32, device=table.device)
        head = [table.data_ptr(), T, C, hh.data_ptr(), O]
        if self.takes_counts:
            head.append(None if counts is None else counts.data_ptr())
        args = head + [scan.data_ptr(), mask.data_ptr(), N, pose.data_ptr(),
                       ctypes.c_float(kw["nn_radius"]),
                       ctypes.c_float(kw["plane_dist_thresh"]),
                       ctypes.c_float(kw["robust_weight_floor"]),
                       self.scratch.data_ptr(), self.scratch.numel(),
                       out.data_ptr()]

        def launch():
            stream = torch.cuda.current_stream(table.device).cuda_stream
            fn = self.lib.lio_fused_corr_floor if floor else self.lib.lio_fused_corr
            err = fn(*args, stream)
            if err != 0:
                raise RuntimeError(f"{self.name}: launch refused ({err})")
            return fc._views(out)

        return launch


def scenes(dev):
    """{name: (table, hh, scan, mask, pose, counts)} at chip_smoke's phase 2
    / 20 (a) shapes."""
    import chip_smoke as cs
    from lio_slam_tpu_torch.ops import voxel_grid as vg
    from lio_slam_tpu_torch.utils import se3

    out = {}
    for halo, cap in SCENES:
        grid, scan, mask, pose, _ = cs.kernel_scene(dev, halo, cap)
        hh = vg.bucket_ids(se3.transform_points(*se3.pose6_to_Rt(pose), scan),
                           grid.cell_size, cs.TABLE, halo)
        out[f"{halo}/{cap}"] = (grid.table, hh, scan, mask, pose, grid.counts)
    return out


def check(kernel, scene, kw):
    """The build against the plain version on the scene; with counts also
    bit-equal to its launch on whole rows."""
    import torch

    import chip_smoke as cs
    from lio_slam_tpu_torch.ops import fused_corr as fc

    table, hh, scan, mask, pose, counts = scene
    got = kernel.launcher(table, hh, scan, mask, pose, counts, kw)()
    torch.cuda.synchronize()
    cs.check_ne(kernel.name, got, fc.fused_ne_from_bucket_ids_ref(
        table, hh, scan, mask, pose, **kw))
    if kernel.takes_counts:
        whole = kernel.launcher(table, hh, scan, mask, pose, None, kw)()
        if not all(torch.equal(a, b) for a, b in zip(got, whole)):
            cs.fail(f"{kernel.name}: counts and whole rows differ")


def timed(kernel, scene, kw, flush, counts=True, floor=False):
    """(warm, cold L2) device ms of the kernel's own launch (on whole rows
    without `counts`; its fixed chain alone with `floor`)."""
    import chip_smoke as cs

    table, hh, scan, mask, pose, grid_counts = scene
    launch = kernel.launcher(table, hh, scan, mask, pose,
                             grid_counts if counts else None, kw, floor)
    return (cs.named_kernel_ms(launch, "fused_corr_groups"),
            cs.named_kernel_ms(launch, "fused_corr_groups",
                               between=lambda: flush.fill_(1.0)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout of the tree to compare with")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the wide-row design's variants")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "results.json"))
    args = ap.parse_args()

    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this study needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    cs.SMI = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(cs.SMI, flush=True)
    dev = torch.device("cuda", 0)

    os.makedirs(OUT_DIR, exist_ok=True)
    jobs = [("this", open(SOURCE).read())]
    if args.parent:
        jobs.append(("parent", open(os.path.join(
            args.parent, "lio_slam_tpu_torch", "ops", "csrc",
            "fused_corr.cu")).read()))
    if args.sweep:
        jobs += [(name, variant_source(subs)) for name, subs in SWEEP]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: build(*job), jobs))
    kernels = {}
    for name, so, report in built:
        for line in report:
            print(f"ptxas {name}: {line}", flush=True)
        kernels[name] = Kernel(name, so, dev)

    kw = dict(nn_radius=1.0, plane_dist_thresh=0.2, robust_weight_floor=0.1)
    cs.warm_profiler(dev)
    sc = scenes(dev)
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    results = {"card": cs.SMI, "turns": {}, "sweep": {}}
    for label, scene in sc.items():
        for k in kernels.values():
            check(k, scene, kw)
    for label, scene in sc.items():
        order = (["parent", "this", "this", "parent"] if args.parent
                 else ["this", "this"])
        times = [(name, *timed(kernels[name], scene, kw, flush))
                 for name in order]
        results["turns"][label] = times
        whole = timed(kernels["this"], scene, kw, flush, counts=False)
        floor = timed(kernels["this"], scene, kw, flush, floor=True)
        results["turns"][label + " this, whole rows"] = whole
        results["turns"][label + " this, launch floor"] = floor
        print(f"{label} ({cs.SMI}): device ms warm / cold L2 in turns: "
              + "; ".join(f"{n} {w:.5f} / {c:.5f}" for n, w, c in times)
              + f"; this on whole rows (counts=None) {whole[0]:.5f} / "
              f"{whole[1]:.5f}; launch floor {floor[0]:.5f} / {floor[1]:.5f}",
              flush=True)
    if args.sweep:
        O_of = {"xy": 3, "full": 1}
        for label in ("xy/72", "full/128"):
            halo, cap = label.split("/")
            names = ["this"] + [name for name, _ in SWEEP] + ["this"]
            rows = []
            for name in names:
                warm, cold = timed(kernels[name], sc[label], kw, flush)
                whole, _ = timed(kernels[name], sc[label], kw, flush,
                                 counts=False)
                warps = kernels[name].lib.lio_fused_corr_block_warps(
                    O_of[halo], int(cap))
                rows.append((name, warps, warm, cold, whole))
                print(f"sweep {label} ({cs.SMI}): {name}: {warps} warps a "
                      f"block, device ms warm {warm:.5f}, cold L2 {cold:.5f}; "
                      f"on whole rows (counts=None) warm {whole:.5f}",
                      flush=True)
            results["sweep"][label] = rows
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
