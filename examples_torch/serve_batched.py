"""Train-while-serve on the PyTorch port: continuous batching under a
seeded Poisson request load, with the master publishing weight
snapshots into the bounded-staleness channel the engine pops from
(reduced config), as ``examples/serve_batched.py``.

    PYTHONPATH=src python examples_torch/serve_batched.py [--device cpu]
"""
import argparse

import numpy as np

import repro_torch.configs as C
from repro_torch.configs.base import ServeConfig
from repro_torch.core.arena import make_layout
from repro_torch.models.api import build_model
from repro_torch.serve import Engine, RequestQueue, WeightPublisher


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=48)
    args = ap.parse_args(argv)

    cfg = C.get_smoke_config("mixtral-8x7b")     # MoE decode path
    model = build_model(cfg, device=args.device)
    sc = ServeConfig(slots=4, max_len=64, max_new=8,
                     arrival="poisson", arrival_rate=0.6,
                     publish_period=4, staleness_bound=8)
    engine = Engine(model, sc.slots, sc.max_len)
    queue = RequestQueue(sc, cfg.vocab_size)
    publisher = WeightPublisher(make_layout(model.param_shapes()), sc,
                                device=args.device)
    engine.attach_publisher(publisher)

    # one explicit request alongside the seeded open-loop traffic
    rng = np.random.default_rng(0)
    queue.submit(list(rng.integers(1, cfg.vocab_size, size=5)))

    for t in range(args.steps):
        if t % sc.publish_period == 0:
            # stand-in master: in training this is the loop's publish
            # hook firing every publish_period master updates
            publisher.publish(engine.params, t)
            engine.refresh_weights(t)
        queue.step()
        ev = engine.step(queue)
        if ev["admits"] or ev["evicts"]:
            print(f"step {ev['step']:3d}: admits={ev['admits']} "
                  f"evicts={ev['evicts']} active={ev['active']}")

    s = engine.stats
    print(f"\nstats: {s.steps} steps, {s.admitted} admitted, "
          f"{s.completed} completed, {s.prefill_tokens} prefill tok, "
          f"{s.decode_tokens} decode tok")
    print(f"publish: {s.publish_pops} pops, staleness mean "
          f"{s.staleness_mean():.2f} max {s.staleness_max} "
          f"(bound {sc.staleness_bound})")
    for rid, toks in engine.completions[:3]:
        print(f"req {rid}: {toks[-8:]}")
    return engine


if __name__ == "__main__":
    main()
