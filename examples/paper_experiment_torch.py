"""Reproduce the paper's Figure-1 comparison (rolling vs random vs full) on
the PyTorch port, printing the loss/accuracy curves.

    PYTHONPATH=src python examples/paper_experiment_torch.py [--rounds 20]
        [--low-heterogeneity] [--device cpu]

Protocol: pre-act ResNet (static BN + scaler), non-IID label-limited client
shards, heterogeneous client capacities {1 .. 1/16}, 40% participation:
the small-scale version of §5, as ``examples/paper_experiment.py`` runs it
in the JAX package.  The rounds run on the card unless ``--device cpu``.
"""
import argparse

from repro_torch.core.paper_protocol import PaperExperiment


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--low-heterogeneity", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    exp = PaperExperiment(n_clients=10, participate=4,
                          labels_per_client=5 if args.low_heterogeneity
                          else 2, n_train=1200, n_test=300, mb=8,
                          device=args.device)
    results = {}
    for scheme in ("rolling", "random", "full"):
        r = exp.run(scheme, rounds=args.rounds, eval_every=5)
        results[scheme] = r
        print(f"\n== {scheme} ==")
        for row in r["curve"]:
            print(f"  round {row['round']:3d}  train {row['train_loss']:.4f}"
                  f"  test {row['test_loss']:.4f}"
                  f"  acc {row['test_acc']:.3f}")
        print(f"  generalization gap (loss): {r['gap']['loss_gap']:+.4f}")

    print("\nSummary (final test loss / gen-gap):")
    for s, r in results.items():
        print(f"  {s:8s} {r['final']['test_loss']:.4f} "
              f"{r['gap']['loss_gap']:+.4f}")


if __name__ == "__main__":
    main()
