"""Quickstart for the PyTorch port: distributed sub-model training
(rolling windows) on a reduced TinyLlama-family model.

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Partitions the model into rolling sub-models (capacity 0.5) and runs
federated rounds (4 clients x 2 local steps) on synthetic bigram data
through the ``repro_torch.api`` facade: the fused window form of
Algorithm 2, as ``examples/quickstart.py`` runs it in the JAX package.
"""
import argparse

from repro_torch import api
from repro_torch.configs.base import SubmodelConfig, get_reduced_config
from repro_torch.data.synthetic import lm_batches
from repro_torch.models import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args(argv)

    cfg = get_reduced_config("tinyllama_1_1b")
    model = build_model(cfg, remat=False)
    params = model.init(0, device=args.device)

    scfg = SubmodelConfig(scheme="rolling", capacity=0.5, local_steps=2,
                          clients_per_round=4, client_lr=0.1,
                          axes=("d_ff", "heads", "kv_heads"))
    fed = api.fed_round(model, scfg, device=args.device)  # window form
    print("window sizes:", fed.scheme.sizes)

    trainer = api.Trainer(fed, params, rng=1)
    params, history = trainer.run(lm_batches(cfg.vocab, (2, 4, 2), seq=64),
                                  args.rounds)
    print("loss:", " ".join(f"{loss:.3f}" for loss in trainer.losses))
    if not trainer.losses[-1] < trainer.losses[0]:
        raise SystemExit("training should reduce the loss")
    print("OK - clients only ever touched capacity-0.5 sub-models.")


if __name__ == "__main__":
    main()
