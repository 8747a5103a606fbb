"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``

The twin of ``repro/launch/serve.py``: drives the port's continuous-
batching engine under a seeded open-loop arrival process (``rc.serve``:
Poisson or bursty traffic), optionally with the bounded-staleness
weight-publication channel attached (``--publish-period`` > 0: a
stand-in master republishes the engine's own weights every N steps and
the engine pops the freshest due snapshot). Prints JAX's stats lines.
It runs on the card; only ``--device cpu`` runs it on the CPU (without
CUDA the default raises).

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --slots 16
    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --smoke \\
        --device cpu --publish-period 4

``main(argv)`` takes the argument list (tests and ``chip_smoke.py`` call
it in process) and returns {"engine", "queue", "publisher"}.
"""
from __future__ import annotations

import argparse

import repro_torch.configs as C
from repro_torch.configs.base import LM_FAMILIES, ServeConfig


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--n-steps", type=int, default=64)
    ap.add_argument("--arrival", default="poisson",
                    choices=("poisson", "bursty"))
    ap.add_argument("--arrival-rate", type=float, default=0.5)
    ap.add_argument("--publish-period", type=int, default=0,
                    help="master steps between weight publishes "
                         "(0 = channel off)")
    ap.add_argument("--staleness-bound", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without CUDA) or "
                         "'cpu'")
    return ap.parse_args(argv)


def main(argv=None):
    from repro_torch.core.arena import make_layout
    from repro_torch.device import resolve_device
    from repro_torch.models.api import build_model
    from repro_torch.serve import Engine, RequestQueue, WeightPublisher
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = (C.get_smoke_config(args.arch) if args.smoke
           else C.get_config(args.arch))
    if cfg.family not in LM_FAMILIES:
        raise SystemExit(f"{args.arch} has no decode path")
    model = build_model(cfg, device=device)
    sc = ServeConfig(slots=args.slots, max_len=args.max_len,
                     max_new=args.max_new, arrival=args.arrival,
                     arrival_rate=args.arrival_rate,
                     publish_period=args.publish_period,
                     staleness_bound=args.staleness_bound,
                     seed=args.seed)
    engine = Engine(model, sc.slots, sc.max_len, seed=sc.seed)
    queue = RequestQueue(sc, cfg.vocab_size)

    publisher = None
    if sc.publish_period > 0:
        publisher = WeightPublisher(make_layout(engine.params), sc,
                                    device=device)
        engine.attach_publisher(publisher)

    for t in range(args.n_steps):
        if publisher is not None and t % sc.publish_period == 0:
            # stand-in master: republish the engine's own weights on
            # the publish clock so the pop/staleness path is exercised
            publisher.publish(engine.params, t)
            engine.refresh_weights(t)
        queue.step()
        engine.step(queue)

    s = engine.stats
    print(f"steps={s.steps} submitted={queue.submitted} "
          f"admitted={s.admitted} completed={s.completed} "
          f"in_flight={engine.in_flight} queued={len(queue)}")
    print(f"prefill_tok={s.prefill_tokens} decode_tok={s.decode_tokens}")
    if publisher is not None:
        print(f"publish: pops={s.publish_pops} misses={s.publish_misses} "
              f"staleness mean={s.staleness_mean():.2f} "
              f"max={s.staleness_max} (bound={sc.staleness_bound})")
    for rid, toks in engine.completions[:4]:
        print(f"req {rid}: {len(toks)} tokens")
    return {"engine": engine, "queue": queue, "publisher": publisher}


if __name__ == "__main__":
    main()
