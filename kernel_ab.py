#!/usr/bin/env python3
"""The density and force kernels of the port, timed in turns against
another build of the same C interface, on one NVIDIA GPU.

    python3 kernel_ab.py --base DIR [--variant NAME=DIR ...] [--out DIR] [--sass]
                         [--sort-tree TREE]

``DIR`` holds another tree of ``libclsph_tpu_torch/csrc/`` sources (for
example an earlier commit's, unpacked under ``build/``). Each tree is
compiled with the package's ``nvcc`` flags into ``build/kernel_ab/``
and loaded in place of the package's library while its turn runs.

On the tables of the 1M cube lattice (those of ``chip_smoke.py``'s phase
2: the main path's, the 16-wide force path's, the q-granular ones, the
asm variant's and the row variant's block table expanded to 32-wide
subblocks, with the fine variant's lists over it) every case is first
run once per library
and held against the base build (densities, hit and tile counts bit for
bit; accelerations by their largest difference and the share of equal
bits) and against its plain PyTorch version (chip_smoke's tolerances).
Then each case is timed in turns (base, package, variants, variants,
package, base): CUDA events (median of 7 calls; the window also holds
the wrapper's host work) and the kernel's device time from
torch.profiler (mean of 5 calls). ptxas's
register and spill report of every build is printed; ``--sass`` also
writes each library's SASS (``cuobjdump -sass``) into the out dir. The
tables' statistics are printed first: the density's (subgroup, 8
candidates) panels that hold a pair within h and that pass
``density_c16``'s box test, and on the force lists the pairs inside the
support against what the per-lane bit walk of ``forces_q32`` pays a
warp at rounds of 32, 64 and 128 candidates.

The last line is one JSON object with every number; it is also written
to ``OUT/kernel_ab.json`` (default ``build/kernel_ab/``). Needs a CUDA device
and exits 2 without one.

The radix sort's C interface is not the one of earlier trees, so
``--sort-tree TREE`` (a whole checkout, for example the parent commit's
``git archive`` unpacked under ``build/``) times that tree's sort in a
process of its own, in turns with the package's and ``torch.sort``, on
``chip_smoke.py``'s sort keys (1M and 4M, lattice Morton codes and
uniform random 30-bit keys).
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
AB_BUILD = ROOT / "build" / "kernel_ab"
PROFILE_CALLS = 5


def device_ms(fn, kernel: str) -> float:
    """Device time (ms) of one call of ``fn``: the summed self device time
    of the kernels whose name holds ``kernel`` over PROFILE_CALLS calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_CALLS):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages() if kernel in e.key)
    return total / PROFILE_CALLS / 1e3 if total > 0 else float("nan")


def ptxas_report(lib: Path) -> list[str]:
    log = lib.with_suffix(".log").read_text().splitlines()
    return [ln.strip() for ln in log
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def build_all(trees: dict) -> dict:
    from libclsph_tpu_torch.ops.kernels import build

    libs = {"package": build.load_library()}
    paths = {"package": build.library_path()}
    for name, src in trees.items():
        paths[name] = build.build(Path(src), AB_BUILD / name)
        libs[name] = build.open_library(paths[name])
    return libs, paths


def cases_1m(dev, libs):
    """The tables' statistics (:func:`panel_stats`, :func:`lane_stats`)
    and the cases (name, profiler key, call, plain call, work, kind) on
    the 1M lattice's tables; kind is "density", or for a force case a
    function that describes the rows of an acceleration that differ."""
    import torch

    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.engine.simulation import SPHSimulation
    from libclsph_tpu_torch.ops.kernels import build, density, forces

    def engine(**over):
        return SPHSimulation(step.StepConfig(**over), device=dev, pretune=False)

    params = cs.water_params(cs.N_BENCH)
    state = init_state(params, dev)
    tm = cs.main_path_tables(state, params, engine())
    t16 = cs.sub16_tables(state, params, engine(**cs.SUB16), 16)
    tq = cs.q_path_tables(state, params, engine(**cs.Q_PATH))
    tb = cs.block_tables(state, params, engine(pallas_variant="row", cand_interval=1))
    ta = cs.asm_tables(state, params, engine(pallas_variant="asm", cand_interval=1,
                                             **cs.Q_PATH))
    del state
    torch.cuda.empty_cache()
    hit2_h = params.h * 1.25
    da, d16 = tm["density_args"], t16["density_args"]
    fm, f16 = tm["force_args"], t16["force_args"]
    fq = (tq["f8"], tq["dens_plain"], tq["real"])
    q32 = fq + tq["q32"] + (params,)
    q128 = fq + tq["q128"] + (params,)
    fine = (tb["f8"], tb["dens"], tb["real"], tb["ids"].repeat_interleave(4, dim=0),
            tb["counts"].repeat_interleave(4), params)
    pairs_m = int(tm["hits_plain"].sum())
    pairs_16 = int(t16["hits_plain"].sum())
    pairs_q = int(tq["hits4"].sum())

    def dens(args, **kw):
        return (lambda: density.density_c16(*args, **kw),
                lambda: density.density_c16_torch(*args, **kw))

    def dens32(args, pairs, groups, hit_sub=32):
        """density_c32 on 32-wide tables. The base build predates the
        densities-only mode (groups 0): there it runs 1 group, as
        density_blocks did, and the comparison drops its hit counts."""
        keep = 2 if groups else 1

        def call():
            g = 1 if groups == 0 and build._library is libs["base"] else groups
            return density.density_c32(*args, groups=g, hit_sub=hit_sub)[:keep]

        def plain():
            return density.density_c32_torch(*args, groups=groups, hit_sub=hit_sub)[:keep]
        return call, plain, cs.density_work(args, plain(), pairs)

    def force(name, args):
        return (lambda: getattr(forces, name)(*args),
                lambda: getattr(forces, name + "_torch")(*args))

    def rows_info(args):
        """For rows of an acceleration that differ: the query's position,
        whether it is real, and how many other particles lie within the
        spiky guard (1e-7) and within h."""
        f8, real = args[0], args[2]

        def info(rows):
            out = []
            for o in rows:
                d = (f8[:, :3] - f8[o, :3]).norm(dim=1)
                out.append(dict(row=o, pos=f8[o, :3].tolist(), real=bool(real[o]),
                                near0=int((d < 1e-7).sum()) - 1,
                                within_h=int((d < params.h).sum())))
            return out
        return info

    def dwork(args, **kw):
        outs = density.density_c16_torch(*args, **kw)
        return cs.density_work(args, outs, int(outs[1].sum()),
                               int(outs[2].sum()) if "hit2_h" in kw else 0)

    dq, dasm = tq["density_args"], ta["density_args"]
    dblk = (tb["pos4"], tb["ids"], tb["counts"], params)
    stats = dict(density_panels=panel_stats(*da[:3], params, 16),
                 density_panels_q32=panel_stats(*dq[:3], params, 32),
                 density_panels_asm=panel_stats(*dasm[:3], params, 32),
                 density_panels_blocks=panel_stats(*dblk[:3], params, 32),
                 lanes_c8=lane_stats(fm, 8), lanes_c16=lane_stats(f16, 16),
                 lanes_c32=lane_stats(q32, 32))
    return stats, [
        ("density_c16 hit_sub 8 (row 1)", "density_", *dens(da), dwork(da), "density"),
        ("density_c16 hit_sub 16 (row 1a)", "density_", *dens(d16, hit_sub=16),
         dwork(d16, hit_sub=16), "density"),
        ("density_c16 hit_sub 16, hit2_h (row 1b)", "density_",
         *dens(d16, hit_sub=16, hit2_h=hit2_h), dwork(d16, hit_sub=16, hit2_h=hit2_h),
         "density"),
        ("density_c32 groups 4 (row 1c)", "density_", *dens32(dq, pairs_q, 4), "density"),
        ("density_c32 groups 1 (row 1d)", "density_", *dens32(dq, pairs_q, 1), "density"),
        ("density_c32 hit_sub 16 (row 1e)", "density_", *dens32(dq, pairs_q, 4, 16),
         "density"),
        ("density_c32 groups 1, asm tables (row 7)", "density_",
         *dens32(dasm, ta["pairs_in"], 1), "density"),
        ("density_blocks: density_c32 densities only, block table (row 8)", "density_",
         *dens32(dblk, tb["pairs_in"], 0), "density"),
        ("forces_q32_c8 (row 2)", "forces_q32_kernel", *force("forces_q32_c8", fm),
         cs.force_work(fm, 8, 32, pairs_m), rows_info(fm)),
        ("forces_q32_c16 (row 6)", "forces_q32_kernel", *force("forces_q32_c16", f16),
         cs.force_work(f16, 16, 32, pairs_16), rows_info(f16)),
        ("forces_q32_c32 (row 4)", "forces_q32_kernel", *force("forces_q32_c32", q32),
         cs.force_work(q32, 32, 32, pairs_q), rows_info(q32)),
        ("forces_blocks fine: forces_q32_c32 (row 8a)", "forces_q32_kernel",
         *force("forces_q32_c32", fine), cs.force_work(fine, 32, 32, tb["pairs_in"]),
         rows_info(fine)),
        ("forces_q128_c32, source unchanged, sph_pair.cuh changed (row 5)",
         "forces_q128_c32_kernel", *force("forces_q128_c32", q128),
         cs.force_work(q128, 32, 128, pairs_q), rows_info(q128)),
    ]


def panel_stats(pos4, cand, count, params, sub) -> dict:
    """On density tables of ``sub``-particle slots (list row b = query
    block b): the (subgroup, run of 8 candidates) panels of the live
    slots, how many hold a pair within h and how many pass the density
    kernels' box test (the subgroup's box and the run's box less than h
    apart, with its 1e-4 margin)."""
    import torch

    nb, cap = cand.shape
    runs = cap * sub // 8
    h2 = float(params.h) ** 2
    q = pos4[:, :3].reshape(nb, 4, 32, 3)
    qlo, qhi = q.amin(dim=2), q.amax(dim=2)  # (nb, 4, 3)
    live = (torch.arange(runs, device=cand.device)[None] * 8 // sub) < count[:, None]
    passed = hit = 0
    rows = max(1, (1 << 24) // (128 * cap * sub))
    for b0 in range(0, nb, rows):
        b1 = min(nb, b0 + rows)
        ids = torch.where(torch.arange(cap, device=cand.device)[None] < count[b0:b1, None],
                          cand[b0:b1], 0).long()
        c = pos4[(ids[..., None] * sub + torch.arange(sub, device=ids.device)), :3]
        c = c.reshape(b1 - b0, runs, 8, 3)
        clo, chi = c.amin(dim=2), c.amax(dim=2)  # (r, runs, 3)
        gap = torch.clamp(torch.maximum(clo[:, None] - qhi[b0:b1, :, None],
                                        qlo[b0:b1, :, None] - chi[:, None]), min=0.0)
        near = (gap * gap).sum(dim=-1) < h2 * 1.0001  # (r, 4, runs)
        on = live[b0:b1, None]
        passed += int((near & on).sum())
        d = q[b0:b1, :, :, None, None, :] - c[:, None, None]  # (r, 4, 32, runs, 8, 3)
        r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        hit += int(((r2 < h2).any(dim=(2, 4)) & on).sum())
    return dict(live_panels=int(live.sum()) * 4, box_pass=passed, with_hit=hit)


def lane_stats(args, width, rounds=(32, 64, 128)) -> dict:
    """On q32 force lists of ``width``-wide entries: the pairs of live
    entries, those inside the support, and for rounds of W candidates the
    sum over (list, round) of the largest per-lane count of pairs inside
    the support (what forces_q32's bit walk costs a warp)."""
    import torch

    f8, _, _, cand, count, params = args
    rows, cap = cand.shape
    h2 = float(params.h) ** 2
    pos = f8[:, :3]
    out = dict(pairs=int(count.sum()) * width * 32, inside=0)
    out.update({f"max_sum_{w}": 0 for w in rounds})
    k = cap * width
    for r0 in range(0, rows, 1024):
        r1 = min(rows, r0 + 1024)
        live = (torch.arange(cap, device=cand.device)[None] < count[r0:r1, None])
        ids = (torch.where(live, cand[r0:r1], 0).long()[..., None] * width
               + torch.arange(width, device=cand.device)).reshape(r1 - r0, k)
        qi = (torch.arange(r0, r1, device=cand.device)[:, None] * 32
              + torch.arange(32, device=cand.device))  # list row b*4+g holds queries b*128+g*32+l
        d = pos[qi][:, :, None, :] - pos[ids][:, None]
        r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        inside = (r2 < h2) & live.repeat_interleave(width, dim=1)[:, None]
        out["inside"] += int(inside.sum())
        pad = -k % max(rounds)  # dead candidates past the last entry
        inside = torch.nn.functional.pad(inside, (0, pad))
        k_pad = k + pad
        for w in rounds:
            per = inside.reshape(r1 - r0, 32, k_pad // w, w).sum(dim=-1)  # (r, lanes, rounds)
            out[f"max_sum_{w}"] += int(per.amax(dim=1).sum())
    return out


# run in another tree's root (``--sort-tree``): its radix sort of the
# keys saved at each path in argv, checked against torch.sort and timed
OTHER_SORT = r"""
import json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from libclsph_tpu_torch.ops import radix_sort
out = {}
for path in sys.argv[1:]:
    keys = torch.load(path).cuda()
    iota = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    k, v = radix_sort.radix_sort_key_val(keys, iota)
    sk, order = torch.sort(keys, stable=True)
    if not (torch.equal(k, sk) and torch.equal(v, order.to(torch.int32))):
        raise SystemExit(f"the sort differs from torch.sort on {path}")
    out[path] = cs.cuda_ms(lambda: radix_sort.radix_sort_key_val(keys, iota))
print(json.dumps(out))
"""


def sort_ab(tree: Path, dev) -> dict:
    """The package's radix sort against the one of another tree (a whole
    checkout, e.g. the parent commit's, whose sort has another C
    interface), run in its own process in that tree, and torch.sort, on
    chip_smoke's sort keys: in turns (other, package, package, other),
    each turn the median of 7 calls (CUDA events)."""
    import torch

    from libclsph_tpu_torch.ops import radix_sort

    paths = {}
    AB_BUILD.mkdir(parents=True, exist_ok=True)
    for n in cs.SORT_KEYS:
        for kind in ("Morton", "random"):
            path = (AB_BUILD / f"sort_keys_{kind}_{n}.pt").resolve()
            torch.save(cs.sort_keys(kind, n, dev).cpu(), path)
            paths[f"{n} {kind}"] = str(path)

    def other():
        proc = subprocess.run([sys.executable, "-c", OTHER_SORT, *paths.values()], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            raise RuntimeError(f"the other tree's sort failed:\n{proc.stderr[-4000:]}")
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        return {name: dict(other=ms[path]) for name, path in paths.items()}

    def package():
        out = {}
        for name, path in paths.items():
            keys = torch.load(path).to(dev)
            iota = torch.arange(keys.shape[0], dtype=torch.int32, device=dev)
            out[name] = dict(
                package=cs.cuda_ms(lambda: radix_sort.radix_sort_key_val(keys, iota)),
                torch=cs.cuda_ms(lambda: torch.sort(keys, stable=True)))
        return out

    turns = [other(), package(), package(), other()]
    res = {}
    for name in paths:
        seq = {}
        for turn in turns:
            for k, v in turn[name].items():
                seq.setdefault(k, []).append(v)
        res[name] = dict(turns=seq, ms={k: statistics.mean(v) for k, v in seq.items()})
        print(f"sort {name}: " + ", ".join(
            f"{k} {statistics.mean(v):.4f} ms ({', '.join(f'{x:.4f}' for x in v)})"
            for k, v in seq.items()), flush=True)
    return res


def compare(kind, out, ref, rows=0) -> dict:
    """The package's (or a variant's) output against another library's
    (or the plain version's) output; for accelerations, up to ``rows``
    differing rows with both values, described by ``kind``."""
    import torch

    if kind == "density":
        same = all(torch.equal(a, b) for a, b in zip(out, ref))
        rel = float(((out[0] - ref[0]).abs() / ref[0].abs()).max())
        counts = all(torch.equal(a, b) for a, b in zip(out[1:], ref[1:]))
        return dict(bit_equal=same, density_rel=rel, counts_equal=counts)
    diff = (out - ref).abs()
    res = dict(bit_equal=bool(torch.equal(out, ref)), max_abs=float(diff.max()),
               amax=float(ref.abs().max()), equal_share=float((out == ref).float().mean()))
    if rows:
        bad = torch.nonzero((out != ref).any(dim=1)).flatten()[:rows].tolist()
        res["differing"] = [dict(info, out=out[o].tolist(), ref=ref[o].tolist())
                            for o, info in zip(bad, kind(bad))]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, help="csrc tree of the base build")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR",
                    help="another csrc tree, timed between the package and the base")
    ap.add_argument("--out", default=str(AB_BUILD))
    ap.add_argument("--sass", action="store_true", help="write each library's SASS")
    ap.add_argument("--sort-tree", default=None, metavar="DIR",
                    help="a whole checkout whose radix sort is timed against the package's")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from libclsph_tpu_torch.engine.simulation import configure_device
    from libclsph_tpu_torch.ops.kernels import build

    dev = configure_device("cuda")
    card = cs.card_line()
    print(f"card: {card}; device {torch.cuda.get_device_name(0)}", flush=True)
    trees = {"base": args.base}
    trees.update(v.split("=", 1) for v in args.variant)
    libs, paths = build_all(trees)
    order = ["package"] + [n for n in trees if n != "base"]
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    result = dict(card=card, builds={}, cases=[])
    for name, path in paths.items():
        result["builds"][name] = ptxas_report(path)
        for line in result["builds"][name]:
            print(f"ptxas {name}: {line}")
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        if args.sass and Path(tool).exists():
            sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True)
            (out_dir / f"sass_{name}.txt").write_text(sass.stdout + sass.stderr)

    def run_with(lib_name, fn):
        build._library = libs[lib_name]
        try:
            return fn()
        finally:
            build._library = libs["package"]

    stats, cases = cases_1m(dev, libs)
    result["table_stats"] = stats
    print(f"table statistics: {json.dumps(stats)}", flush=True)
    for name, key, call, plain, work, kind in cases:
        outs = {lib: run_with(lib, call) for lib in ["base"] + order}
        torch.cuda.synchronize()
        ref = plain()
        rec = dict(name=name, bound_ms=cs.bound(*work)[0], bound_by=cs.bound(*work)[1],
                   checks={})
        for lib in order:
            vs_base = compare(kind, outs[lib], outs["base"], rows=4)
            vs_plain = compare(kind, outs[lib], ref)
            ok = (vs_plain["density_rel"] <= 1e-5 and vs_plain["counts_equal"]
                  if kind == "density" else vs_plain["max_abs"] <= 1e-5 * vs_plain["amax"])
            if not ok:
                raise RuntimeError(f"{name} {lib}: disagrees with the plain version {vs_plain}")
            rec["checks"][lib] = dict(vs_base=vs_base, vs_plain=vs_plain)
        del outs, ref
        turns = ["base"] + order + order[::-1] + ["base"]
        seq = [(lib, run_with(lib, lambda: cs.cuda_ms(call)),
                run_with(lib, lambda: device_ms(call, key))) for lib in turns]
        times = {lib: [(t, d) for other, t, d in seq if other == lib]
                 for lib in dict.fromkeys(turns)}
        rec["turns"] = seq
        rec["ms"] = {lib: statistics.mean(t for t, _ in v) for lib, v in times.items()}
        rec["device_ms"] = {lib: statistics.mean(d for _, d in v) for lib, v in times.items()}
        line = f"{name}: bound {rec['bound_ms']:.4f} ms by {rec['bound_by']};"
        for lib in ["base"] + order:
            ev = ", ".join(f"{t:.4f}" for t, _ in times[lib])
            dv = ", ".join(f"{d:.4f}" for _, d in times[lib])
            line += (f" {lib} {rec['ms'][lib]:.4f} ms ({ev}; device "
                     f"{rec['device_ms'][lib]:.4f}: {dv})")
            if lib != "base":
                line += f" {json.dumps(rec['checks'][lib]['vs_base'])};"
        print(line, flush=True)
        result["cases"].append(rec)
        torch.cuda.empty_cache()
    if args.sort_tree:
        result["sort"] = sort_ab(Path(args.sort_tree), dev)
    (out_dir / "kernel_ab.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
