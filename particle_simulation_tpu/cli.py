"""Command-line driver with the reference's 8-argument positional contract.

Reference (run:1-9, src/main.cu:8-47):
    main MODE VERBOSE INIT_N MAX_T BLOCK_SIZE MAX_N SLEEP_TIME POISSON_TS
with MODE in {bench, 30 (Dynamic), 31 (CPU Sync), 32 (Naive), test}; the
reference's mode 33 (Dynamic Old) has no engine here and is refused.

Usage:  python -m particle_simulation_tpu 30 0 1000000 10 256 50000000 100 100
Extra keyword-style overrides (grid=, cs=, seed=, precision=, mesh=N for a
multi-chip run over an N-device mesh, ckpt=DIR, field=, platform=,
bucket=0/1 to disable/enable capacity-ladder bucketing [default 1];
bench mode: profile=ci|quick|full and resume=0/1) are accepted after the
positional args — a new-framework extension.  Any other
scalar SimConfig field is also accepted as key=value (knobs like
rng_mode=perstep, bbox_subgrid=0, grid_live_chunks=4), coerced by the
field's type; unknown keys are a hard error.
"""

from __future__ import annotations

import dataclasses
import sys
import time

from .config import SCHEDULER_MODES, SimConfig


@dataclasses.dataclass
class CliOptions:
    mode: str
    config: SimConfig
    ckpt_dir: str = ""
    mesh: int = 0          # 0 = single chip; N = shard over an N-device mesh
    bucket: bool = True    # capacity-ladder bucketing (bucket=0 to run every
    # step at full MAX_N capacity, the literal reference shape)
    bench_profile: str = "full"   # bench mode: profile=ci|quick|full
    bench_resume: bool = False    # bench mode: resume=1 continues the CSV


def parse_args(argv) -> CliOptions:
    mode = argv[0]
    if mode == "33":
        raise SystemExit(
            "mode 33 (Dynamic Old) is not available: use 30 (Dynamic), "
            "31 (CPU Sync) or 32 (Naive)"
        )
    cfg = SimConfig()
    positional = [a for a in argv[1:] if "=" not in a]
    if mode in SCHEDULER_MODES or mode == "test":
        # the reference requires all 8 positional args (src/main.cu:10-24);
        # accept mode-only for defaults but reject partial arg lists
        if positional and len(positional) != 7:
            raise SystemExit(
                "usage: MODE VERBOSE INIT_N MAX_T BLOCK_SIZE MAX_N "
                "SLEEP_TIME POISSON_TS [key=value ...]\n"
                f"got {len(positional) + 1} positional args, need 8"
            )
    if len(positional) == 7:
        cfg = cfg.replace(
            verbose=int(positional[0]),
            init_n=int(positional[1]),
            poisson_steps=int(positional[2]),
            block_size=int(positional[3]),
            capacity=int(positional[4]),
            sleep_time_ns=int(positional[5]),
            poisson_timestep=int(positional[6]),
        )
    opts = CliOptions(mode=mode, config=cfg)
    for extra in argv[1:]:
        if "=" not in extra:
            continue
        key, _, val = extra.partition("=")
        if key == "grid":
            g = int(val)
            cfg = cfg.replace(grid_size=(g, g, g))
        elif key == "cs":
            cfg = cfg.replace(cross_section_path=val)
        elif key == "seed":
            cfg = cfg.replace(seed=int(val))
        elif key == "precision":
            cfg = cfg.replace(precision=val)
            if val == "f64":
                import jax

                jax.config.update("jax_enable_x64", True)
        elif key == "field":
            cfg = cfg.replace(field_model=val)
        elif key == "bfield":
            # uniform cyclotron vector Ω = qB/m (rad/s) for integrator=boris
            parts = tuple(float(x) for x in val.split(","))
            if len(parts) != 3:
                raise SystemExit("bfield takes three comma-separated floats")
            cfg = cfg.replace(b_field=parts)
        elif key == "gridmode":
            cfg = cfg.replace(grid_mode=val)
        elif key == "ckpt":
            opts.ckpt_dir = val
        elif key == "mesh":
            opts.mesh = int(val)
        elif key == "bucket":
            opts.bucket = bool(int(val))
        elif key == "profile":
            if val not in ("ci", "quick", "full"):
                raise SystemExit("profile must be ci, quick, or full")
            opts.bench_profile = val
        elif key == "resume":
            opts.bench_resume = bool(int(val))
        elif key == "platform":
            import jax

            jax.config.update("jax_platforms", val)
        else:
            # generic knob passthrough: any scalar SimConfig field (e.g.
            # rng_mode=perstep, bbox_subgrid=0) coerced by its default's
            # type; unknown
            # keys stay a hard error (strict-CLI contract)
            default = getattr(cfg, key, None)
            if isinstance(default, bool):
                cfg = cfg.replace(**{key: bool(int(val))})
            elif isinstance(default, int):
                cfg = cfg.replace(**{key: int(val)})
            elif isinstance(default, float):
                cfg = cfg.replace(**{key: float(val)})
            elif isinstance(default, str):
                cfg = cfg.replace(**{key: val})
            else:
                raise SystemExit(f"unknown override {extra!r}")
    if mode in SCHEDULER_MODES:
        cfg = cfg.replace(scheduler=SCHEDULER_MODES[mode])
    opts.config = cfg
    return opts


def _run_sharded(opts: CliOptions) -> None:
    """Multi-chip run: shard particles over an N-device mesh (mesh=N).

    ``init_n``/``capacity`` keep their reference meaning as GLOBAL totals;
    they are divided across shards.
    """
    import jax

    from .parallel.sharded import make_mesh, run_pic_sharded

    n = opts.mesh
    if len(jax.devices()) < n:
        raise SystemExit(
            f"mesh={n} requested but only {len(jax.devices())} devices "
            "visible (use XLA_FLAGS=--xla_force_host_platform_device_count"
            "=N with platform=cpu for a virtual mesh)"
        )
    cfg = opts.config
    per_shard = cfg.replace(
        init_n=max(1, cfg.init_n // n), capacity=max(128, cfg.capacity // n)
    )
    mesh = make_mesh(n)
    print(
        f"PIC sharded over {n} devices: per-shard init_n={per_shard.init_n} "
        f"capacity={per_shard.capacity}"
    )
    state, history = run_pic_sharded(per_shard, mesh)
    last = history[-1] if history else {"n": 0}
    print(f"Final amount of particles: {last['n']}")
    print(f"Particles added: {sum(h['added'] for h in history)}")
    print(f"Particles removed: {sum(h['removed'] for h in history)}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 2
    start = time.perf_counter()
    from .utils import compile_cache

    compile_cache.configure()
    opts = parse_args(argv)
    mode, cfg = opts.mode, opts.config

    if mode == "bench":
        from .benchmarks import run_benchmark

        run_benchmark(profile=opts.bench_profile, resume=opts.bench_resume)
    elif mode in SCHEDULER_MODES:
        if opts.mesh:
            _run_sharded(opts)
        else:
            from .observability import make_log_hook
            from .runtime import run_pic

            hook = make_log_hook(cfg)
            if opts.ckpt_dir:
                from .checkpoint import make_checkpoint_hook

                ckpt_hook = make_checkpoint_hook(cfg, opts.ckpt_dir)
                log_hook = hook

                def hook(t, state):
                    log_hook(t, state)
                    ckpt_hook(t, state)

                if not cfg.verbose:
                    cfg = cfg.replace(verbose=1)
            # auto_bucket: run each Poisson step on the smallest
            # capacity-ladder prefix that holds the population — physics is
            # bit-identical (genealogy-keyed RNG; overflow redoes the step
            # one bucket up) but a reference-shaped MAX_N=5e7 run at small
            # init_n does not pay full-capacity step cost.  bucket=0
            # restores the literal full-capacity execution shape.
            run_pic(cfg, on_step=hook, auto_bucket=opts.bucket)
    elif mode == "test":
        from .testing import run_unit_test

        ok = run_unit_test(cfg)
        if not ok:
            return 1
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    print(f"CPU time of program: {(time.perf_counter() - start) * 1e3:.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
