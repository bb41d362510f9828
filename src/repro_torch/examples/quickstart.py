"""Quickstart: graph-regularized semi-supervised training via ``repro_torch.api``.

The port's counterpart of ``examples/quickstart.py``, with the same flags,
defaults and configs.  One ``ExperimentConfig`` describes the whole
pipeline (synthetic corpus, k-NN affinity graph, balanced partition,
meta-batch synthesis and the Eq.-3 objective); ``Experiment.run()`` trains
it, then trains its supervised twin (the same experiment with γ = κ = 0)
on the same corpus, eval data, graph and plan, and prints each run's
accuracy by epoch.  Components are selected by registry name in the config
(``repro_torch.api.registry`` lists them).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--epochs 10]
    PYTHONPATH=src python -m repro_torch.examples.quickstart --pairwise pallas
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Runs on the card unless ``--device cpu`` is given, and raises without a
GPU otherwise.  Each run's line ends with its seconds and, on the card,
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.api import (BatchConfig, DataConfig, Experiment,
                             ExperimentConfig, ExperimentResult, GraphConfig,
                             ObjectiveConfig, TrainConfig)
from repro_torch.device import card_label


def configs(epochs: int = 10, n: int = 4000, label_ratio: float = 0.02,
            gamma: float = 1.0, pairwise: str = "auto"
            ) -> tuple[ExperimentConfig, ExperimentConfig]:
    """The SSL experiment and its supervised twin (γ = κ = 0), as the
    reference's quickstart builds them from its flags."""
    cfg = ExperimentConfig(
        name="quickstart",
        data=DataConfig(n=n, n_classes=16, input_dim=128,
                        manifold_dim=10, label_ratio=label_ratio),
        graph=GraphConfig(builder="knn_rbf", k=10),
        batch=BatchConfig(pipeline="meta_batch", batch_size=512),
        objective=ObjectiveConfig(gamma=gamma, kappa=1e-4,
                                  weight_decay=1e-5, pairwise=pairwise),
        train=TrainConfig(n_epochs=epochs, base_lr=1e-2, dropout=0.0,
                          hidden_dim=512, n_hidden=3))
    supervised = dataclasses.replace(
        cfg, name="supervised",
        objective=dataclasses.replace(cfg.objective, gamma=0.0, kappa=0.0))
    return cfg, supervised


def experiments(cfg: ExperimentConfig, supervised: ExperimentConfig,
                device: str = "cuda") -> tuple[Experiment, Experiment]:
    """The built SSL experiment and the supervised one on its corpus,
    eval data, graph and plan."""
    exp = Experiment(cfg, device=device).build()
    return exp, Experiment(supervised, corpus=exp.corpus,
                           eval_data=exp.eval_data, graph=exp.graph,
                           plan=exp.plan, device=device)


def main(argv: list[str] | None = None) -> list[ExperimentResult]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--label-ratio", type=float, default=0.02)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--pairwise", default="auto",
                    choices=["auto", "ref", "pallas", "fused"],
                    help="pairwise-kernel registry entry")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg, supervised = configs(args.epochs, args.n, args.label_ratio,
                              args.gamma, args.pairwise)
    exp, sup = experiments(cfg, supervised, args.device)
    print(f"corpus: {exp.corpus.n} points, "
          f"{int(exp.corpus.label_mask.sum())} labeled "
          f"({100 * exp.corpus.label_ratio():.1f}%)")
    print(f"graph: {exp.graph.n_nodes} nodes, {exp.graph.n_edges} edges; "
          f"{exp.plan.mini_block_labels.max() + 1} mini-blocks -> "
          f"{exp.plan.n_meta} meta-batches")

    print(f"training SSL (gamma={args.gamma:.2f}, "
          f"pairwise={args.pairwise!r}) vs fully-supervised...")
    where = card_label(exp.device)
    results = []
    for experiment in (exp, sup):
        res = experiment.run()
        accs = " ".join(f"{h['eval/acc']:.3f}" for h in res.history)
        print(f"   {res.config.name:<11} acc by epoch: {accs} "
              f"({res.seconds:.1f}s on {where})")
        results.append(res)
    return results


if __name__ == "__main__":
    main()
