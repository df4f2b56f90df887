"""Training / testing CLI of the PyTorch port.

    python -m scene_3dreconstruction_mvsnet_tpu_torch.train_cli --mode train \\
        --dataset dtu_yao --trainpath <DTU root> --trainlist lists/dtu/train.txt \\
        --testlist lists/dtu/val.txt --batch_size 4 --numdepth 192 \\
        --interval_scale 1.06 --lrepochs 2,3,4,5,6,7,8,9,10,11,12,13,14,15:1.2 \\
        --dtype bfloat16 --device cuda

Counterpart of the repository's ``train.py`` (the reference trainer's flag
names and mini-DSLs) over the port's Trainer. The datasets are the port's
``data`` package (numpy and Pillow). Flags that only exist
for the TPU kernels are refused rather than ignored.

Data-parallel training runs one process per card under ``torchrun``, which
sets the process group's environment; ``--batch_size`` is the global batch:

    torchrun --nproc_per_node 4 -m scene_3dreconstruction_mvsnet_tpu_torch.train_cli \
        --multihost --batch_size 8 ... --device cuda
"""

from __future__ import annotations

import argparse
import random
import sys

import numpy as np
import torch

from .utils import print_args

# flag -> why the port refuses it
REFUSED = {
    "--pallas_grad": "a TPU kernel switch; on the card the training sweep always runs K1 and K3",
    "--pallas_sweep": "a TPU kernel switch; on the card the training sweep always runs K1 and K3",
    "--pallas_regression": "a TPU kernel switch; the regression kernel runs at eval on the card",
    "--env_samples": "TPU kernel window envelopes do not exist on the card",
    "--plan_check": "TPU kernel window envelopes do not exist on the card",
    "--flat_features": "the flat block-Toeplitz layout exists for the TPU's tiles",
    "--flat_costreg": "the flat block-Toeplitz layout exists for the TPU's tiles",
}


class _Refuse(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not supported by the PyTorch port: {REFUSED[option_string]}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MVSNet trainer, PyTorch/CUDA port")
    p.add_argument("--mode", default="train", choices=["train", "test", "profile"],
                   help="profile: trace eval steps with torch.profiler into <logdir>/profile/trace.json")
    p.add_argument("--model", default="mvsnet", help="select model (models.require_model; MVSNet is the one that trains)")
    p.add_argument("--refine", action="store_true", help="use the refine network")
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
    p.add_argument("--debug_MVSnet", type=int, default=0,
                   help="debug bitmask (the reference's bits): each summary step dumps the selected forward stages "
                        "as PNGs under <logdir>/debug_train/step<N>/debug/")
    p.add_argument("--remat", action="store_true",
                   help="recompute the plane sweep and CostRegNet in the backward instead of holding their "
                        "activations from the forward (more time; the sweep kernel runs again)")
    p.add_argument("--img_cache", default=None,
                   help="directory for a cache of decoded images, shared with the JAX package's (the next epochs "
                        "load the arrays instead of decoding the PNGs)")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group torchrun describes (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                        "MASTER_PORT) and train data-parallel, one process per card (cuda:LOCAL_RANK; gloo with "
                        "--device cpu); --batch_size is the global batch")
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
    group = None
    if args.multihost:
        import torch.distributed as dist

        from .parallel import initialize_multihost

        rank, world, local_rank = initialize_multihost(backend="nccl" if device.type == "cuda" else "gloo")
        if device.type == "cuda":
            device = torch.device("cuda", local_rank)
        group = dist.group.WORLD
        print(f"multihost: rank {rank}/{world} on {device}, global batch {args.batch_size}")
    if args.testpath is None:
        args.testpath = args.trainpath

    seed = args.seed if args.seed != 0 else random.randint(1, 99999999)
    if group is not None:  # every rank walks rank 0's batch order
        shared = torch.tensor([seed], dtype=torch.int64, device=device)
        torch.distributed.broadcast(shared, src=0)
        seed = int(shared.item())
    np.random.seed(seed)
    torch.manual_seed(seed)
    print("argv:", sys.argv[1:] if argv is None else argv)
    print_args(args)

    from .data import find_dataset_def
    from .models import require_model
    from .train.loop import Trainer

    model_def = require_model(args.model, "train")
    MVSDataset = find_dataset_def(args.dataset)
    common = dict(Nlights=args.Nlights, pairfile=args.pairfile, seed=seed, img_cache=args.img_cache)
    train_dataset = MVSDataset(args.trainpath, args.trainlist, "train", args.NtrainViews,
                               args.numdepth, args.interval_scale, **common)
    test_dataset = MVSDataset(args.testpath, args.testlist, "test", args.NtestViews,
                              args.numdepth, args.interval_scale, **common)

    model = model_def(refine=args.refine, depth_chunk=args.depth_chunk,
                   dtype=torch.bfloat16 if args.dtype == "bfloat16" else None, remat=args.remat)
    trainer = Trainer(
        model, train_dataset, test_dataset,
        logdir=args.logdir, epochs=args.epochs, lr=args.lr, lrepochs=args.lrepochs,
        weight_decay=args.wd, batch_size=args.batch_size, summary_freq=args.summary_freq,
        save_freq=args.save_freq, seed=seed, num_workers=args.num_workers, debug_mvsnet=args.debug_MVSnet,
        device=device, group=group,
    )
    if args.resume:
        trainer.resume()
    elif args.loadckpt:
        print(f"Loading checkpoint {args.loadckpt}")
        trainer.load(args.loadckpt)
    print(f"Number of model parameters: {sum(p.numel() for p in model.parameters())}")

    if args.mode == "train":
        trainer.train()
    elif args.mode == "profile":
        trainer.profile()
    else:
        print("final", trainer.test())
    if group is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
