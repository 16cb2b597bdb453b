"""Time what XLA makes of the stencil apply and the small-N GMRES on a GPU.

Two measurements that decide whether a hand-written kernel is worth
writing (docs/design.md, ROADMAP):

- the two-field stencil apply ``DPPOperator.stacked_matvec`` at 3D 128^3
  in float64 and float32, against a plain elementwise pass (negation) over
  the same bytes: the ratio of their kernel times (from a trace) is the
  share of the achievable bandwidth the stencil reaches (wall times per
  call are also reported; at these sizes they include dispatch);
- the ``lax.while_loop`` GMRES of ``solve_dpp(PLAIN_GMRES_PARAMS)`` at 2D
  N=16 and N=64: wall time per solve, and the device's idle share inside
  one traced solve (busy = union of the device's kernel intervals).

Wall times end in ``block_until_ready``. Prints one JSON line per
measurement and writes them all to ``chiprun_out/xla_baselines.json``.

Usage: python experiments/xla_baselines.py
"""

from __future__ import annotations

import glob
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def busy_seconds(trace_dir: str, window: str = "window") -> tuple:
    """(device busy s, window s) of the traced region named ``window``:
    busy is the union of the GPU's kernel intervals that fall inside it."""
    from jax.profiler import ProfileData

    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)[0]
    pd = ProfileData.from_file(path)
    win = None
    spans = []
    for plane in pd.planes:
        for line in plane.lines:
            for ev in line.events:
                if plane.name.startswith("/host") and ev.name == window:
                    win = (ev.start_ns, ev.end_ns)
                elif plane.name.startswith("/device:GPU") and line.name.startswith("Stream"):
                    spans.append((ev.start_ns, ev.end_ns))
    if win is None:
        raise RuntimeError(f"no host span named {window!r} in {path}")
    lo, hi = win
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-9, (hi - lo) * 1e-9


def traced(fn, *args):
    """Run ``fn(*args)`` once under the profiler; (busy s, window s)."""
    import jax

    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        with jax.profiler.TraceAnnotation("window"):
            jax.block_until_ready(fn(*args))
        jax.profiler.stop_trace()
        return busy_seconds(d)


def per_call(fn, args, reps: int) -> float:
    """Seconds per call over ``reps`` back-to-back calls (one final wait)."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def stencil(n: int = 128, reps: int = 50) -> list:
    import jax
    import jax.numpy as jnp

    from perphil_tpu.forms import create_function_spaces, mixed_space
    from perphil_tpu.mesh import create_cube_mesh
    from perphil_tpu.models.dpp import DPPParameters
    from perphil_tpu.ops.assembly import DPPOperator

    mesh = create_cube_mesh(n, n, n, hexahedral=True)
    _, V = create_function_spaces(mesh)
    op = DPPOperator(mixed_space(V), DPPParameters())
    mv = jax.jit(op.stacked_matvec())
    neg = jax.jit(lambda x: -x)
    out = []
    for dtype in (jnp.float64, jnp.float32):
        x = jax.random.normal(jax.random.PRNGKey(0), (2,) + op.grid_shape, dtype)
        nbytes = 2 * x.nbytes  # read x, write y
        t_mv = per_call(mv, (x,), reps)
        t_cp = per_call(neg, (x,), reps)

        def ten(f, x=x):
            for _ in range(10):
                y = f(x)
            return y

        busy_mv, win_mv = traced(ten, mv)
        busy_cp, _ = traced(ten, neg)
        rec = {
            "what": f"stencil stacked_matvec {n}^3 {jnp.dtype(dtype).name}",
            "bytes_per_call": nbytes,
            "stencil_s": t_mv,
            "copy_s": t_cp,
            "share_of_copy_bandwidth_wall": t_cp / t_mv,
            "stencil_busy_s_per_call": busy_mv / 10,
            "copy_busy_s_per_call": busy_cp / 10,
            "stencil_kernel_gbs": nbytes / (busy_mv / 10) / 1e9,
            "copy_kernel_gbs": nbytes / (busy_cp / 10) / 1e9,
            "share_of_copy_bandwidth": busy_cp / busy_mv,
            "idle_share_10_calls": 1.0 - busy_mv / win_mv,
        }
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def gmres(N: int, reps: int = 3) -> dict:
    import jax

    from chip_smoke import build_problem
    from perphil_tpu.solvers import solve_dpp
    from perphil_tpu.solvers.parameters import PLAIN_GMRES_PARAMS

    W, params, bcs = build_problem("quad", N)

    def solve():
        sol = solve_dpp(W, params, bcs, solver_parameters=PLAIN_GMRES_PARAMS)
        jax.block_until_ready(sol.solution.data)
        return sol

    sol = solve()  # compile
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        solve()
        times.append(time.perf_counter() - t0)
    busy, win = traced(lambda: solve().solution.data)
    rec = {
        "what": f"plain GMRES 2D quad N={N}",
        "iterations": sol.iteration_number,
        "solve_s": times,
        "s_per_iteration": min(times) / sol.iteration_number,
        "traced_window_s": win,
        "device_busy_s": busy,
        "idle_share": 1.0 - busy / win,
    }
    print(json.dumps(rec), flush=True)
    return rec


def main() -> None:
    import jax

    import perphil_tpu  # noqa: F401  (enables x64)
    from perphil_tpu.config import gpu_identity, setup_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"xla_baselines: needs a GPU, JAX found {dev.platform!r}")
    setup_compilation_cache()
    card = gpu_identity()
    print(f"nvidia-smi: {card}", flush=True)
    recs = stencil() + [gmres(16), gmres(64)]
    out = ROOT / "chiprun_out" / "xla_baselines.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": card, "device_kind": dev.device_kind,
                               "records": recs}, indent=1) + "\n")


if __name__ == "__main__":
    main()
