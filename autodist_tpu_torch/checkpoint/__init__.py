"""Checkpoint layer (PyTorch counterpart of ``autodist_tpu/checkpoint/``):
the plain saver in the JAX package's original layout, its integrity
checks, the serving export and the lifecycle CLI. The JAX package's
``ShardedSaver`` joins it with the partitioned layouts (ROADMAP A item
7): its files are the mesh's shards."""
from autodist_tpu_torch.checkpoint import integrity
from autodist_tpu_torch.checkpoint.integrity import CheckpointDamaged
from autodist_tpu_torch.checkpoint.saver import Saver
from autodist_tpu_torch.checkpoint.saved_model_builder import (
    SavedModelBuilder, export_for_serving)


def latest_checkpoint(directory):
    """(step, saver) of the newest committed AND valid checkpoint in
    ``directory``, or (None, None). ``latest()`` runs the fast integrity
    validation, so a torn or damaged newest step is skipped here, and
    checkpoints stamped ``healthy: false`` are skipped the same way. The
    one authority on "is there something to restore, and through which
    saver" (auto-resume in ``Runner.init``)."""
    try:
        saver = Saver(directory=directory)
        base = saver.latest()
    except OSError:
        return None, None
    if base is None:
        return None, None
    return int(base.rsplit("ckpt-", 1)[1]), saver


__all__ = ["Saver", "SavedModelBuilder", "export_for_serving",
           "latest_checkpoint", "integrity", "CheckpointDamaged"]
