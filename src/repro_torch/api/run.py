"""Run an experiment of the port from a JSON config file.

    PYTHONPATH=src python -m repro_torch.api.run --config exp.json
    PYTHONPATH=src python -m repro_torch.api.run --epochs 4 --device cuda

``--dump-config`` prints the fully-resolved config (defaults included) as
JSON and exits — the printed document round-trips through ``--config`` and
is the same document the reference's ``python -m repro.api.run`` takes.
``--device`` defaults to ``cuda`` and fails without a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.api import Experiment, ExperimentConfig


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None,
                    help="path to an ExperimentConfig JSON file")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override train.n_epochs")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--dump-config", action="store_true",
                    help="print the resolved config as JSON and exit")
    args = ap.parse_args(argv)

    if args.config:
        with open(args.config) as fh:
            cfg = ExperimentConfig.from_dict(json.load(fh))
    else:
        cfg = ExperimentConfig()
    if args.epochs is not None:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, n_epochs=args.epochs))
    if args.dump_config:
        print(json.dumps(cfg.to_dict(), indent=2))
        return

    result = Experiment(cfg, device=args.device).run()
    for row in result.history:
        acc = f" eval/acc={row['eval/acc']:.4f}" if "eval/acc" in row else ""
        print(f"epoch {row['epoch']:3d}: loss={row['loss/total']:.4f}"
              f" lr={row['lr']:.4g}{acc}")
    print(f"[{cfg.name}] {len(result.history)} epochs "
          f"in {result.seconds:.1f}s on {args.device}")


if __name__ == "__main__":
    main()
