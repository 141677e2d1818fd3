#!/usr/bin/env python3
"""Fidelity of the port's production path with collisions active.

    python3 experiments/torch_fidelity_collision.py [--device cuda|cpu] [--n 65536]
        [--scene box] [--budget 4000] [--target 256] [--rows 512]

A water dam-break of N particles (bench_torch's parameters) settles into
``scenes/box.obj`` (floor and four walls, open top, so the water rests
inside the contact band) in chunks of SETTLE_CHUNK substeps, each chunk
re-run with the engine's capacity growth when it raises a flag, until the
baked distance field predicts ``--target`` particles colliding on the
next substep (or ``--budget`` substeps ran). One production substep, at
the settled dt without the adaptive retry and without the sort, is then
compared with a float64 chain over the same scene geometry: the pair sums
(torch_fidelity_64k's oracle), the leapfrog, and the distance-field
response (bake, trilinear interpolation, respond;
collisionsv2.cl:57-138, :249-336). Half the rows are a seeded random
sample, half are drawn from the particles the device predicts will
collide. Rows whose float64 distance lies within BAND of the contact
threshold are excluded (the branch is discontinuous there) and their
count must stay rare. Prints one JSON line of errors: density and
acceleration relative, position in units of h, velocity relative to the
largest speed; exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "experiments")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402

import bench_torch  # noqa: E402
import torch_fidelity_64k as free  # noqa: E402

N = 65_536
SCENE = "box"
SETTLE_BUDGET = 4000
SETTLE_CHUNK = 24
TARGET_CONTACTS = 256
ROWS = 512
BAND = 2e-6  # the contact-threshold exclusion band (f32 ulp scale of d)
MIN_COLLIDED = 20


def load_scene(name, params, dev):
    """``scenes/<name>.obj`` (threshold 2h) and its baked device scene."""
    from libclsph_tpu_torch.ops import collisions
    from libclsph_tpu_torch.scene.scene import Scene

    scene = Scene.load(name + ".obj", params.h * 2.0, scenes_dir=os.path.join(ROOT, "scenes"))
    return collisions.build_device_scene(scene, dev)


def predicted_collisions(state, dt, scene):
    """The particles that collide now, and those whose position after one
    substep at the current intermediate velocity would (the device's
    distance field)."""
    from libclsph_tpu_torch.ops import collisions

    p = state.position
    now = collisions.handle_collisions(scene, p, p, state.velocity, 0.0, dt).collision_happened
    nxt = collisions.handle_collisions(scene, p, p + state.intermediate_velocity * dt,
                                       state.velocity, 0.0, dt).collision_happened
    return now, nxt


def settle(state, params, scene, engine, budget, target, log=None):
    """Chunks of SETTLE_CHUNK substeps until ``target`` particles are
    predicted to collide (or ``budget`` substeps ran). Returns (state, dt,
    substeps run, predicted contacts)."""
    dt, done, pred = None, 0, 0
    while done < budget:
        state, dt = bench_torch.warm_up(state, params, scene, engine, SETTLE_CHUNK, dt)
        done += SETTLE_CHUNK
        now, nxt = predicted_collisions(state, dt, scene)
        pred = int(nxt.sum())
        if log:
            log(f"settle {done}: contacts now {int(now.sum())}, predicted {pred}, "
                f"min y {float(state.position[:, 1].min()):.3f}, dt {float(dt):.3e}")
        if pred >= target:
            break
    return state, dt, done, pred


def sample_rows(state, dt, scene, rows=ROWS, seed=free.SEED) -> np.ndarray:
    """Half of ``rows`` drawn at random, half from the predicted colliders."""
    n = state.position.shape[0]
    rng = np.random.default_rng(seed)
    pred = np.flatnonzero(predicted_collisions(state, dt, scene)[1].cpu().numpy())
    half = min(rows // 2, n)
    take = min(rows // 2, len(pred))
    return np.unique(np.concatenate([rng.choice(n, half, replace=False),
                                     rng.choice(pred, take, replace=False)]))


class DistanceField:
    """The float64 signed distance field on the device bake's grid
    layout (collisionsv2.cl:57-138), and the response of one particle
    (:249-336)."""

    def __init__(self, scene, params, dt):
        from libclsph_tpu_torch.ops import collisions

        def f64(t):
            return t.detach().cpu().double().numpy()

        self.bb_min, self.bb_max = f64(scene.bb_min), f64(scene.bb_max)
        self.bb_size = scene.bb_size.cpu().numpy().astype(np.int64)
        self.bb_offset = scene.bb_offset.cpu().numpy().astype(np.int64)
        self.rot, self.trans = f64(scene.rotations), f64(scene.translations)
        self.rvert = f64(scene.rvertices)
        self.faces = scene.face_count
        self.far = collisions.DF_FAR
        self.contact = collisions.CONTACT_DISTANCE
        self.restitution = float(params.restitution)
        self.dt = float(dt)

    @staticmethod
    def _seg_dist(rpx, rpy, rpz, x1, y1, x2, y2):
        a, b = rpy - x1, rpz - y1
        c, d = x2 - x1, y2 - y1
        lsq = c * c + d * d
        param = (a * c + b * d) / lsq if lsq != 0.0 else -1.0
        xx = x1 if param < 0 else (x2 if param > 1 else x1 + param * c)
        yy = y1 if param < 0 else (y2 if param > 1 else y1 + param * d)
        return np.sqrt(rpx**2 + (rpz - yy) ** 2 + (rpy - xx) ** 2)

    def _face_distance(self, p, f):
        """Unsigned point-to-face distance and the sign's source
        (collisionsv2.cl:92-131)."""
        rpx, rpy, rpz = self.rot[f] @ (p + self.trans[f])
        v1x, v1y, v2x, v2y = self.rvert[f]
        denom = v2x * v1y
        if denom != 0.0:
            aa = (rpy * v1y) / denom
            bb = -(rpy * v2y - rpz * v2x) / denom
            if aa > 0 and bb > 0 and aa + bb < 1:
                return abs(rpx), rpx
        d = min(self._seg_dist(rpx, rpy, rpz, 0.0, 0.0, v1x, v1y),
                self._seg_dist(rpx, rpy, rpz, v1x, v1y, v2x, v2y),
                self._seg_dist(rpx, rpy, rpz, 0.0, 0.0, v2x, v2y))
        return d, rpx

    def at_gridpoint(self, g):
        """The distance at flat gridpoint ``g`` (first strict minimum over
        the faces whose box holds it gives the sign)."""
        owner = np.searchsorted(self.bb_offset, g, side="right") - 1
        size = self.bb_size[owner]
        li = g - self.bb_offset[owner]
        sx, sz = size[0], size[2]
        plane = sx * sz
        x, z, y = (li % plane) % sx, (li % plane) // sx, li // plane
        denom = np.maximum(size.astype(np.float64) - 1.0, 1.0)
        p = (np.array([x, y, z], np.float64) * (self.bb_max[owner] - self.bb_min[owner])
             / denom + self.bb_min[owner])
        best, sign = self.far, 1.0
        for f in range(self.faces):
            if np.all(p <= self.bb_max[f]) and np.all(p >= self.bb_min[f]):
                d, rpx = self._face_distance(p, f)
                if d < best:
                    best, sign = d, rpx
        return np.copysign(best, sign) if best < self.far else self.far

    def respond(self, p_new, v_next):
        """handle_collisions for one particle: the last face box holding
        it, its clipped cell, the trilinear distance and, inside the
        contact distance, the push along the field's gradient and the
        velocity response. Returns (position, velocity, distance or None
        outside every face box)."""
        face = -1
        for f in range(self.faces):
            if np.all(p_new <= self.bb_max[f]) and np.all(p_new >= self.bb_min[f]):
                face = f
        if face < 0:
            return p_new, v_next, None
        size = self.bb_size[face]
        lo = self.bb_min[face]
        side = (self.bb_max[face] - lo) / np.maximum(size.astype(np.float64) - 1.0, 1.0)
        cell = np.clip(((p_new - lo) / side).astype(np.int64), 0, size - 2)
        sx, sz = size[0], size[2]
        base_i = self.bb_offset[face] + cell[1] * sx * sz + sx * cell[2] + cell[0]
        c = {(a, b, e): self.at_gridpoint(base_i + a + sx * sz * b + sx * e)
             for a in (0, 1) for b in (0, 1) for e in (0, 1)}
        bx, by, bz = cell * side + lo
        sxs, sys_, szs = side
        px, py, pz = p_new

        def wavg(q, q1, q2, f1, f2):
            return ((q2 - q) / (q2 - q1)) * f1 + ((q - q1) / (q2 - q1)) * f2

        def bil(xq, yq, x1, y1, x2, y2, f00, f01, f10, f11):
            return wavg(yq, y1, y2, wavg(xq, x1, x2, f00, f10), wavg(xq, x1, x2, f01, f11))

        dn = bil(px, pz, bx, bz, bx + sxs, bz + szs, c[0, 0, 0], c[0, 0, 1], c[1, 0, 0],
                 c[1, 0, 1])
        up = bil(px, pz, bx, bz, bx + sxs, bz + szs, c[0, 1, 0], c[0, 1, 1], c[1, 1, 0],
                 c[1, 1, 1])
        d = wavg(py, by, by + sys_, dn, up)
        if d >= self.contact:
            return p_new, v_next, d
        right = bil(py, pz, by, bz, by + sys_, bz + szs, c[1, 0, 0], c[1, 0, 1], c[1, 1, 0],
                    c[1, 1, 1])
        left = bil(py, pz, by, bz, by + sys_, bz + szs, c[0, 0, 0], c[0, 0, 1], c[0, 1, 0],
                   c[0, 1, 1])
        back = bil(px, py, bx, by, bx + sxs, by + sys_, c[0, 0, 0], c[0, 1, 0], c[1, 0, 0],
                   c[1, 1, 0])
        front = bil(px, py, bx, by, bx + sxs, by + sys_, c[0, 0, 1], c[0, 1, 1], c[1, 0, 1],
                    c[1, 1, 1])
        nrm = np.array([right - left, up - dn, front - back])
        length = np.linalg.norm(nrm)
        if length > 0:
            nrm = nrm / length
        p_out = p_new + abs(d) * nrm
        speed = max(np.linalg.norm(v_next), 1e-12)
        coef = 1.0 + self.restitution * abs(d) / (self.dt * speed)
        return p_out, v_next - coef * float(nrm @ v_next) * nrm, d


def chain_errors(state, out, params, scene, dt, rows) -> dict:
    """The substep ``out`` from ``state`` (at ``dt``, no retry, no sort)
    against the float64 chain on ``rows``: the pair sums, then the
    leapfrog and the distance-field response of each row. Adds to
    torch_fidelity_64k's errors the position (units of h) and velocity
    (relative to the largest speed) after the substep, the rows that
    collided and those excluded in the threshold band."""
    rho, acc = free.oracle(state, params, rows)
    errors = free.pair_errors(state, out, params, rows, (rho, acc))
    pos, iv = free.host(state.position), free.host(state.intermediate_velocity)
    pos_dev, vel_dev = free.host(out.position), free.host(out.velocity)
    field = DistanceField(scene, params, dt)
    h = float(params.h)
    vscale = max(float(np.abs(vel_dev).max()), 1e-9)
    pos_err = np.full(len(rows), np.nan)
    vel_err = np.full(len(rows), np.nan)
    excluded = collided = 0
    for k, i in enumerate(rows):
        v_next = iv[i] + acc[k] * field.dt
        p_out, v_out, d = field.respond(pos[i] + v_next * field.dt, v_next)
        if d is not None and abs(d - field.contact) < BAND:
            excluded += 1
            continue
        if d is not None and d < field.contact:
            collided += 1
        v_full = 0.5 * (iv[i] + v_out)  # the full-step velocity (advection.cl:16)
        pos_err[k] = np.abs(pos_dev[i] - p_out).max() / h
        vel_err[k] = np.abs(vel_dev[i] - v_full).max() / vscale
    return dict(errors, position_rms_h=float(np.sqrt(np.nanmean(pos_err**2))),
                position_max_h=float(np.nanmax(pos_err)),
                velocity_rms_rel=float(np.sqrt(np.nanmean(vel_err**2))),
                velocity_max_rel=float(np.nanmax(vel_err)), collided=int(collided),
                excluded=int(excluded))


def band_is_rare(errors) -> bool:
    return errors["excluded"] <= max(2, errors["rows"] // 50)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--scene", default=SCENE)
    ap.add_argument("--budget", type=int, default=SETTLE_BUDGET, help="most settle substeps")
    ap.add_argument("--target", type=int, default=TARGET_CONTACTS,
                    help="predicted contacts that end the settle")
    ap.add_argument("--rows", type=int, default=ROWS)
    args = ap.parse_args(argv)

    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine.simulation import SPHSimulation, configure_device

    dev = configure_device(args.device)
    params = bench_torch.build_params(args.n)
    scene = load_scene(args.scene, params, dev)
    engine = SPHSimulation(device=dev, pretune=False)
    t0 = time.perf_counter()
    state, dt, done, pred = settle(init_state(params, dev), params, scene, engine,
                                   args.budget, args.target,
                                   lambda m: print(m, file=sys.stderr, flush=True))
    out = free.probe(state, dt, params, scene, engine, adaptive_dt=False)
    bench_torch.sync(dev)
    settle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    errors = chain_errors(state, out, params, scene, dt,
                          sample_rows(state, dt, scene, args.rows))
    checks = dict(settled=pred >= args.target, band_rare=band_is_rare(errors),
                  collisions=errors["collided"] >= MIN_COLLIDED, bar=free.passes(errors))
    print(json.dumps(dict(
        metric=f"collision fidelity against a float64 chain, {args.n} water particles in "
               f"{args.scene}.obj",
        n=args.n, settle_substeps=done, predicted_contacts=pred, dt=float(dt), **errors,
        checks=checks, settle_s=round(settle_s, 3),
        oracle_s=round(time.perf_counter() - t0, 3), config=str(engine.step_config),
        device=str(dev), card=bench_torch.card_line() if dev.type == "cuda" else None,
        host_cpu=bench_torch.host_cpu())))
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
