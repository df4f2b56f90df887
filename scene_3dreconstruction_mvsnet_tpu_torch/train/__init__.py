"""Training runtime of the port: the train/eval steps, the MultiStepLR
schedule, checkpoints in the reference's ``.ckpt`` format, and the epoch
loop (``train.loop.Trainer``, not imported here: it reuses the JAX
package's numpy-only data loader, and the steps run without it).
Counterpart of ``scene_3dreconstruction_mvsnet_tpu/train``."""

from .checkpoint import find_latest, load_model, restore_checkpoint, save_checkpoint
from .lr import make_scheduler, multistep_factor, parse_lrepochs
from .metrics import depth_metrics
from .state import make_eval_step, make_optimizer, make_train_step

__all__ = [
    "depth_metrics",
    "find_latest",
    "load_model",
    "make_eval_step",
    "make_optimizer",
    "make_scheduler",
    "make_train_step",
    "multistep_factor",
    "parse_lrepochs",
    "restore_checkpoint",
    "save_checkpoint",
]
