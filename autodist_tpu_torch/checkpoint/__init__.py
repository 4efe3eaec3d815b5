"""Checkpoint layer (PyTorch counterpart of ``autodist_tpu/checkpoint/``):
the plain saver in the JAX package's original layout, the sharded saver
(each process writes the slices it holds, in the JAX package's sharded
format), their integrity checks, the serving export and the lifecycle
CLI."""
from autodist_tpu_torch.checkpoint import integrity
from autodist_tpu_torch.checkpoint.integrity import CheckpointDamaged
from autodist_tpu_torch.checkpoint.saver import Saver
from autodist_tpu_torch.checkpoint.sharded import ShardedSaver
from autodist_tpu_torch.checkpoint.saved_model_builder import (
    SavedModelBuilder, export_for_serving)


def latest_checkpoint(directory):
    """(step, saver) of the newest committed AND valid checkpoint in
    ``directory`` across BOTH formats (:class:`Saver` and
    :class:`ShardedSaver`; the newer step wins), or (None, None).
    ``latest()`` runs the fast integrity validation, so a torn or damaged
    newest step is skipped here, and checkpoints stamped ``healthy:
    false`` are skipped the same way. The one authority on "is there
    something to restore, and through which saver": auto-resume
    (``Runner.init``), the sentinel's rollback and the sync-elastic
    restart."""
    best = (None, None)
    for saver_cls in (Saver, ShardedSaver):
        try:
            saver = saver_cls(directory=directory)
            base = saver.latest()
        except OSError:
            continue
        if base is not None:
            step = int(base.rsplit("ckpt-", 1)[1])
            if best[0] is None or step > best[0]:
                best = (step, saver)
    return best


__all__ = ["Saver", "ShardedSaver", "SavedModelBuilder", "export_for_serving",
           "latest_checkpoint", "integrity", "CheckpointDamaged"]
