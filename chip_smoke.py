"""Smoke test of the PIC-MCC main path on one NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below but multi
    python chip_smoke.py --multi   # four cards: the sharded path only

Phases, one line each:

  * device  - the JAX device (platform, kind, count) and the card's name and
              power limit from nvidia-smi (read by a child that never imports
              JAX).  Anything but a GPU exits non-zero before any work;
  * compile - the dynamic engine's Poisson step compiled at the bench point
              (1M electrons, capacity 2M, T=100, 256^3), with
              ``compiled.memory_analysis()``;
  * main    - the CLI in-process at the reference's canonical deployment
              (mode 30: 1M electrons, MAX_N 5e7, 512^3 grid, T=100, sine
              table; src/test.cu:5-23) for 3 Poisson steps;
  * oracle  - the engine against the XLA ``sync`` cadence on the card, as
              sorted particle multisets: the bench point for 2 Poisson steps
              and the constant-table collision stress (1M x T=100, 1 step);
  * timing  - the engine against the XLA ``naive`` cadence at the bench
              point, steady window after a warm-up;
  * field   - the bbox one-hot histogram deposit against the plain
              ``.at[].add`` deposit on the card, with both times;
  * multi   - (``--multi`` only) ``run_pic_sharded_device`` on a 4-card mesh,
              1M electrons per card, replicated and slab grid modes, each
              against the same global population on one card.  Each time
              is split into the one-off setup and the step loop at T=100
              and at T=1; one card running one card's share is timed too.

The last line is one JSON object: {"ok": true, "device": {...}}.  A failing
phase raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

BENCH = dict(init_n=1_000_000, capacity=2_000_000, poisson_timestep=100,
             grid_size=(256, 256, 256), block_size=256)
CANONICAL_ARGV = ["30", "0", "1000000", "3", "256", "50000000", "0", "100"]


def card_identity() -> str:
    """``name, power.limit`` of the card, from a child that never imports
    JAX (so it cannot take the card's memory)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def require_gpu(devices, count=None):
    """(platform, kind, count) of ``devices``; raises SystemExit unless they
    are GPUs (and, if given, exactly ``count`` of them)."""
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {platform!r}); "
            "this script measures the card and refuses to run elsewhere"
        )
    if count is not None and len(devices) < count:
        raise SystemExit(
            f"chip_smoke: --multi needs {count} GPUs, JAX found {len(devices)}"
        )
    return platform, devices[0].device_kind, len(devices)


def _log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def _config(**kw):
    from particle_simulation_tpu import SimConfig

    return SimConfig(**{**BENCH, **kw})


def _steps(state, table, cfg, n_steps, first=0):
    """``n_steps`` Poisson steps; returns (state, per-step metric dicts)."""
    import jax.numpy as jnp

    from particle_simulation_tpu.ops.step import poisson_step

    out = []
    for t in range(n_steps):
        state, m = poisson_step(state, jnp.uint32(first + t), table, cfg)
        out.append({k: int(v) for k, v in m.items() if k != "pushes"})
    return state, out


def _sync_steps(state, table, cfg, n_steps):
    """The ``sync`` oracle: generation fixed point as a host loop."""
    import jax.numpy as jnp

    from particle_simulation_tpu.ops.step import poisson_step_sync_host

    out = []
    for t in range(n_steps):
        state, m = poisson_step_sync_host(
            state, jnp.uint32(t), table, cfg.replace(scheduler="sync")
        )
        out.append({k: int(v) for k, v in m.items() if k != "pushes"})
    return state, out


def _pad(state, capacity):
    from particle_simulation_tpu.runtime import _pad_state

    return _pad_state(state, capacity)


def phase_compile(table):
    import jax
    import jax.numpy as jnp

    from particle_simulation_tpu import setup_particles
    from particle_simulation_tpu.ops.step import _poisson_step_t, _step_config
    from particle_simulation_tpu.runtime import _bucket_size, _slice_state

    cfg = _config(scheduler="dynamic")
    w = _bucket_size(cfg.init_n, cfg.capacity)
    state = _slice_state(setup_particles(cfg), w)
    t0 = time.perf_counter()
    compiled = _poisson_step_t.lower(
        state, jnp.uint32(0), table, jnp.int32(cfg.poisson_timestep),
        _step_config(cfg.replace(capacity=w)),
    ).compile()
    _log("compile", f"dynamic step at w={w}: {time.perf_counter() - t0:.1f} s; "
         f"{compiled.memory_analysis()}")
    jax.block_until_ready(state)


def phase_main():
    import jax

    from particle_simulation_tpu import cli

    t0 = time.perf_counter()
    rc = cli.main(CANONICAL_ARGV)
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    stats = jax.devices()[0].memory_stats() or {}
    _log("main", f"cli {' '.join(CANONICAL_ARGV)}: {time.perf_counter() - t0:.1f} s "
         f"wall incl. compile; peak_bytes_in_use="
         f"{stats.get('peak_bytes_in_use', 'not reported')}")


def compare_multisets(a, b, what):
    """Raise unless the two states hold the same sorted particle multiset."""
    import numpy as np

    from particle_simulation_tpu.runtime import sorted_particle_array

    x, y = sorted_particle_array(a), sorted_particle_array(b)
    if x.shape != y.shape or not np.array_equal(x, y):
        rows = -1
        if x.shape == y.shape:
            rows = int((np.abs(x - y).max(axis=1) > 0).sum())
        raise AssertionError(
            f"{what}: engine and sync differ ({x.shape} vs {y.shape}, "
            f"{rows} rows differ)"
        )


def oracle_case(table, cfg, n_steps, oracle_capacity, what):
    """Engine through the capacity ladder (runtime._bucketed_step) vs
    ``sync`` in a container that holds every child of a step (sync keeps
    dead rows until the step ends)."""
    import jax.numpy as jnp

    from particle_simulation_tpu import setup_particles
    from particle_simulation_tpu.runtime import _bucketed_step

    start = setup_particles(cfg)
    eng_cfg = cfg.replace(scheduler="dynamic")
    eng, m_eng = start, []
    t0 = time.perf_counter()
    for t in range(n_steps):
        eng, m, _w = _bucketed_step(eng, jnp.uint32(t), table, eng_cfg)
        m_eng.append({k: int(v) for k, v in m.items() if k != "pushes"})
    t_eng = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref, m_ref = _sync_steps(_pad(start, oracle_capacity), table,
                             cfg.replace(capacity=oracle_capacity), n_steps)
    t_ref = time.perf_counter() - t0
    for m in m_eng + m_ref:
        if m["overflow"]:
            raise AssertionError(f"{what}: overflow, the comparison is void")
    keys = ("n", "added", "removed", "pushes_lo", "pushes_hi")
    strip = lambda ms: [{k: m[k] for k in keys} for m in ms]
    if strip(m_eng) != strip(m_ref):
        raise AssertionError(f"{what}: metrics differ {m_eng} vs {m_ref}")
    compare_multisets(eng, ref, what)
    _log("oracle", f"{what}: bit-exact over {n_steps} step(s), final n="
         f"{m_eng[-1]['n']}, added={sum(m['added'] for m in m_eng)}; "
         f"engine {t_eng:.1f} s, sync {t_ref:.1f} s (incl. compile)")


def phase_oracle(sine, const):
    oracle_case(sine, _config(), 2, 1 << 22, "bench point 1M/T=100/256^3")
    oracle_case(const, _config(), 1, 1 << 26,
                "collision stress const table 1M/T=100")


def time_steps(table, cfg, w, warm=1, steps=3):
    """Steady per-step time of ``cfg`` at container ``w``: warm-up steps,
    then ``steps`` steps timed with block_until_ready."""
    import jax

    from particle_simulation_tpu import setup_particles
    from particle_simulation_tpu.runtime import _slice_state

    state = setup_particles(cfg.replace(capacity=max(w, cfg.capacity)))
    state = _slice_state(state, w) if w < state.capacity else state
    cfg = cfg.replace(capacity=w)
    state, _ = _steps(state, table, cfg, warm)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    state, ms = _steps(state, table, cfg, steps, first=warm)
    jax.block_until_ready(state)
    dt = (time.perf_counter() - t0) / steps
    pushes = sum(m["pushes_lo"] + (m["pushes_hi"] << 30) for m in ms)
    ovf = any(m["overflow"] for m in ms)
    return dt, pushes / (steps * dt), ms[-1]["n"], ovf


def phase_timing(table):
    from particle_simulation_tpu.runtime import _bucket_size

    base = _config()
    w_eng = _bucket_size(base.init_n, base.capacity)
    runs = (
        ("dynamic", w_eng), ("naive", base.capacity), ("naive", 1 << 22),
    )
    for sched, w in runs:
        dt, rate, n, ovf = time_steps(table, base.replace(scheduler=sched), w)
        _log("timing", f"{sched} at w={w}: {dt * 1e3:.3f} ms/Poisson step, "
             f"{rate:.6g} pushes/s, final n={n}"
             + (" (container overflowed: children dropped)" if ovf else ""))


def phase_field():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from particle_simulation_tpu import setup_particles
    from particle_simulation_tpu.ops import grid as grid_ops

    cfg = _config()
    st = setup_particles(cfg)
    weight = (jnp.arange(st.capacity) < st.n).astype(jnp.int32)
    S = cfg.bbox_subgrid

    @jax.jit
    def bbox(pos, weight):
        idx = grid_ops.cell_indices(pos, cfg.cell_size, cfg.grid_size)
        lo, _hi = grid_ops.live_bbox(idx, weight, cfg.grid_size)
        origin = jnp.maximum(lo - 1, 0)
        rel = idx - origin[None, :]
        flat = (rel[:, 0] * S + rel[:, 1]) * S + rel[:, 2]
        flat = jnp.where(weight > 0, flat, -1)
        counts = grid_ops._mxu_histogram(
            flat, S ** 3, lanes=cfg.bbox_hist_lanes
        )
        return counts, origin

    @jax.jit
    def plain(pos, weight):
        return grid_ops.deposit(pos, weight, cfg.cell_size, cfg.grid_size)

    def timed(fn):
        jax.block_until_ready(fn(st.pos, weight))
        t0 = time.perf_counter()
        for _ in range(5):
            out = jax.block_until_ready(fn(st.pos, weight))
        return out, (time.perf_counter() - t0) / 5

    (counts, origin), t_bbox = timed(bbox)
    full, t_plain = timed(plain)
    g = np.asarray(full).reshape(cfg.grid_size)
    o = np.asarray(origin)
    window = g[o[0]:o[0] + S, o[1]:o[1] + S, o[2]:o[2] + S]
    if int(g.sum()) != int(np.asarray(counts).sum()) or not np.array_equal(
        window, np.asarray(counts).reshape(S, S, S)
    ):
        raise AssertionError("bbox histogram deposit differs from .at[].add")
    _log("field", f"bbox one-hot histogram == .at[].add deposit "
         f"({int(g.sum())} particles); bbox {t_bbox * 1e3:.3f} ms, "
         f".at[].add on {cfg.grid_size[0]}^3 {t_plain * 1e3:.3f} ms")


def _live_sorted(state):
    """Live particles (with their genealogy ids) as lexsorted rows."""
    import numpy as np

    mask = np.asarray(state.status) == -1
    rows = np.concatenate([
        np.asarray(state.id_lo)[mask, None].astype(np.float64),
        np.asarray(state.id_hi)[mask, None].astype(np.float64),
        np.asarray(state.pos)[mask], np.asarray(state.vel)[mask],
        np.asarray(state.acc)[mask].astype(np.float64),
    ], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def _sharded_run(cfg, mesh, table):
    """(run, times in ms): a warm-up run compiles, a second identical run is
    timed whole (``run``, per Poisson step), then split into the one-off
    ``setup_sharded`` and the device-resident step loop (per Poisson step)
    at the run's T and at T=1, where the mobility phase does almost nothing
    and the field phase, collectives and launches remain."""
    import jax

    from particle_simulation_tpu.parallel.sharded import (
        run_pic_sharded_device,
        setup_sharded,
        sharded_poisson_loop,
    )

    run_pic_sharded_device(cfg, mesh, table)
    t0 = time.perf_counter()
    run = run_pic_sharded_device(cfg, mesh, table)
    k = max(len(run.steps), 1)
    times = {"run": (time.perf_counter() - t0) * 1e3 / k}
    cfg_w = cfg.replace(capacity=run.last_bucket)
    t0 = time.perf_counter()
    state = jax.block_until_ready(setup_sharded(cfg_w, mesh))
    times["setup"] = (time.perf_counter() - t0) * 1e3
    for key, t_steps in (("loop", cfg.poisson_timestep), ("loop_t1", 1)):
        c = cfg_w.replace(poisson_timestep=t_steps)
        jax.block_until_ready(sharded_poisson_loop(state, table, c, mesh, k))
        t0 = time.perf_counter()
        jax.block_until_ready(sharded_poisson_loop(state, table, c, mesh, k))
        times[key] = (time.perf_counter() - t0) * 1e3 / k
    return run, times


def _fmt_times(t):
    return (f"run {t['run']:.3f} ms/step (setup {t['setup']:.3f} ms once), "
            f"step loop {t['loop']:.3f} ms/step, at T=1 {t['loop_t1']:.3f}")


def sharded_case(cfg, n_cards, table, reference, grid_mode):
    """Run ``cfg`` (per-card sizes) on an ``n_cards`` mesh and compare it
    with ``reference`` (the same global population on one device): the
    histories and the sorted live multisets must agree exactly (the
    shard-count invariance comparison)."""
    import numpy as np

    from particle_simulation_tpu.parallel.sharded import make_mesh

    one, _t_one = reference
    many, t_many = _sharded_run(cfg.replace(grid_mode=grid_mode),
                                make_mesh(n_cards), table)
    if any(s.overflow for s in many.steps + one.steps):
        raise AssertionError(f"{grid_mode}: overflow, the comparison is void")
    hist = lambda r: [(s.n, s.added, s.removed) for s in r.steps]
    if hist(many) != hist(one):
        raise AssertionError(
            f"{grid_mode}: {n_cards}-card history {hist(many)} != "
            f"one-device {hist(one)}"
        )
    if not np.array_equal(_live_sorted(many.state), _live_sorted(one.state)):
        raise AssertionError(f"{grid_mode}: sorted multisets differ")
    _log("multi", f"{grid_mode}: {n_cards} cards == 1 device over "
         f"{len(many.steps)} steps, final n={many.final_n}; "
         f"{n_cards} cards: {_fmt_times(t_many)}")


def phase_multi(table, n_cards=4, per_card=1_000_000, grid=256, t_steps=100):
    import jax

    from particle_simulation_tpu import SimConfig
    from particle_simulation_tpu.parallel.sharded import make_mesh

    cfg = SimConfig(init_n=per_card, capacity=2 * per_card, poisson_steps=2,
                    poisson_timestep=t_steps, grid_size=(grid,) * 3,
                    scheduler="dynamic")
    one = make_mesh(1, jax.devices()[:1])
    # one card's share alone: what each card of the mesh should take
    _run, t_share = _sharded_run(cfg, one, table)
    _log("multi", f"1 device, {per_card} electrons: {_fmt_times(t_share)}")
    one_cfg = cfg.replace(init_n=per_card * n_cards,
                          capacity=2 * per_card * n_cards)
    reference = _sharded_run(one_cfg, one, table)
    _log("multi", f"1 device, {per_card * n_cards} electrons: "
         f"{_fmt_times(reference[1])}")
    for mode in ("replicated", "slab"):
        sharded_case(cfg, n_cards, table, reference, mode)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        from particle_simulation_tpu.utils import compile_cache
    except ImportError:
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    compile_cache.configure()
    import jax

    from particle_simulation_tpu.cross_section import bundled_paths, load_table

    platform, kind, count = require_gpu(jax.devices(), 4 if args.multi else None)
    card = card_identity()
    _log("device", f"{platform} / {kind} / {count} device(s); card: {card}")
    sine = load_table()
    const = load_table(bundled_paths()[1])
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(sine)
    else:
        phase_compile(sine)
        phase_main()
        phase_oracle(sine, const)
        phase_timing(sine)
        phase_field()
    _log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
