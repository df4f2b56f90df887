"""Training / testing CLI of the PyTorch port.

    python -m scene_3dreconstruction_mvsnet_tpu_torch.train_cli --mode train \\
        --dataset dtu_yao --trainpath <DTU root> --trainlist lists/dtu/train.txt \\
        --testlist lists/dtu/val.txt --batch_size 4 --numdepth 192 \\
        --interval_scale 1.06 --lrepochs 2,3,4,5,6,7,8,9,10,11,12,13,14,15:1.2 \\
        --dtype bfloat16 --device cuda

Counterpart of the repository's ``train.py`` (the reference trainer's flag
names and mini-DSLs) over the port's Trainer. The datasets are the JAX
package's framework-free readers (numpy and Pillow). Flags that only exist
for the TPU kernels, and features not ported yet, are refused rather than
ignored.
"""

from __future__ import annotations

import argparse
import random
import sys

import numpy as np
import torch

# flag -> why the port refuses it
REFUSED = {
    "--pallas_grad": "a TPU kernel switch; on the card the training sweep always runs K1 and K3",
    "--pallas_sweep": "a TPU kernel switch; on the card the training sweep always runs K1 and K3",
    "--pallas_regression": "a TPU kernel switch; the regression kernel runs at eval on the card",
    "--env_samples": "TPU kernel window envelopes do not exist on the card",
    "--plan_check": "TPU kernel window envelopes do not exist on the card",
    "--flat_features": "the flat block-Toeplitz layout exists for the TPU's tiles",
    "--flat_costreg": "the flat block-Toeplitz layout exists for the TPU's tiles",
    "--multihost": "multi-device training is not ported yet",
    "--remat": "rematerialisation is not ported yet",
    "--refine": "RefineNet is not ported yet",
    "--debug_MVSnet": "the debug dumps are not ported yet",
    "--img_cache": "the decoded-image cache is not ported yet",
}


class _Refuse(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not supported by the PyTorch port: {REFUSED[option_string]}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MVSNet trainer, PyTorch/CUDA port")
    p.add_argument("--mode", default="train", choices=["train", "test"])
    p.add_argument("--dataset", default="dtu_yao", choices=["dtu_yao", "blender"])
    p.add_argument("--trainpath", default="", help="train datapath")
    p.add_argument("--testpath", help="test datapath (defaults to trainpath)")
    p.add_argument("--trainlist", default="lists/dtu/train.txt")
    p.add_argument("--testlist", default="lists/dtu/test.txt")
    p.add_argument("--pairfile", default="pair.txt")
    p.add_argument("--epochs", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--lrepochs", type=str, default="10,12,14:2",
                   help="epoch ids to downscale lr and the downscale rate")
    p.add_argument("--wd", type=float, default=0.0, help="weight decay")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--numdepth", type=int, default=192)
    p.add_argument("--interval_scale", type=float, default=1.06)
    p.add_argument("--Nlights", type=str, default="1:1", help="'k:total' light sampling DSL (blender datasets)")
    p.add_argument("--NtrainViews", type=int, default=3)
    p.add_argument("--NtestViews", type=int, default=5)
    p.add_argument("--loadckpt", default=None)
    p.add_argument("--logdir", default="./outputs/debug")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--summary_freq", type=int, default=100)
    p.add_argument("--save_freq", type=int, default=1)
    p.add_argument("--seed", type=int, default=0, metavar="S", help="0 for random seed")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="conv compute dtype (bfloat16 = the fast path)")
    p.add_argument("--depth_chunk", type=int, default=None,
                   help="plane-sweep depth chunk size of the plain path (CPU)")
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N or cpu")
    for flag in REFUSED:
        p.add_argument(flag, nargs="?", action=_Refuse, help=argparse.SUPPRESS)
    return p


def main(argv: list[str] | None = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.resume and args.mode != "train":
        parser.error("--resume requires --mode train")
    if args.resume and args.loadckpt:
        parser.error("--resume and --loadckpt are exclusive")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"train_cli: --device {args.device} but torch.cuda.is_available() is False "
            "(no NVIDIA GPU or no CUDA build of torch); pass --device cpu to run the plain path"
        )
    if args.testpath is None:
        args.testpath = args.trainpath

    seed = args.seed if args.seed != 0 else random.randint(1, 99999999)
    np.random.seed(seed)
    torch.manual_seed(seed)
    print("argv:", sys.argv[1:] if argv is None else argv)
    print("args:", vars(args))

    # the JAX package's dataset readers import only numpy and Pillow
    from scene_3dreconstruction_mvsnet_tpu.data import find_dataset_def

    from .models import MVSNet
    from .train.loop import Trainer

    MVSDataset = find_dataset_def(args.dataset)
    common = dict(Nlights=args.Nlights, pairfile=args.pairfile, seed=seed)
    train_dataset = MVSDataset(args.trainpath, args.trainlist, "train", args.NtrainViews,
                               args.numdepth, args.interval_scale, **common)
    test_dataset = MVSDataset(args.testpath, args.testlist, "test", args.NtestViews,
                              args.numdepth, args.interval_scale, **common)

    model = MVSNet(depth_chunk=args.depth_chunk, dtype=torch.bfloat16 if args.dtype == "bfloat16" else None)
    trainer = Trainer(
        model, train_dataset, test_dataset,
        logdir=args.logdir, epochs=args.epochs, lr=args.lr, lrepochs=args.lrepochs,
        weight_decay=args.wd, batch_size=args.batch_size, summary_freq=args.summary_freq,
        save_freq=args.save_freq, seed=seed, num_workers=args.num_workers, device=device,
    )
    if args.resume:
        trainer.resume()
    elif args.loadckpt:
        print(f"Loading checkpoint {args.loadckpt}")
        trainer.load(args.loadckpt)
    print(f"Number of model parameters: {sum(p.numel() for p in model.parameters())}")

    if args.mode == "train":
        trainer.train()
    else:
        print("final", trainer.test())


if __name__ == "__main__":
    main()
