"""Dataset and dataloader assembly shared by the drivers (the port's copy
of lightningdot_tpu/training/trainer_utils.py; reference
build_dataloader / load_dataset, dvl/trainer.py:28-37,193-209).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union

from lightningdot_tpu_torch.data.feat_db import ImageDbGroup
from lightningdot_tpu_torch.data.itm import ItmFastDataset
from lightningdot_tpu_torch.data.loader import DataLoader
from lightningdot_tpu_torch.data.txt_db import TxtTokDb
from lightningdot_tpu_torch.parallel.mesh import process_count, process_index


class ConcatDataset:
    """Minimal torch ConcatDataset equivalent (trainer.py:202)."""

    def __init__(self, datasets: Sequence[Any]):
        self.datasets = list(datasets)
        self._offsets = []
        total = 0
        for d in self.datasets:
            self._offsets.append(total)
            total += len(d)
        self._total = total

    def __len__(self):
        return self._total

    def __getitem__(self, i):
        for off, d in zip(reversed(self._offsets), reversed(self.datasets)):
            if i >= off:
                return d[i - off]
        raise IndexError(i)

    def new_epoch(self, *args, **kwargs):
        for d in self.datasets:
            d.new_epoch(*args, **kwargs)


def build_dataloader(dataset, collate_fn, is_train: bool, opts,
                     batch_size: Optional[int] = None,
                     seed: Optional[int] = None) -> DataLoader:
    """trainer.py:28-37.

    ``--loader_workers`` parallelizes whole-batch fetch+collate with order
    preservation (the ITM datasets' __getitem__ is deterministic)."""
    if batch_size is None:
        batch_size = opts.train_batch_size if is_train else opts.valid_batch_size
    return DataLoader(dataset, batch_size=batch_size, shuffle=is_train,
                      drop_last=False, collate_fn=collate_fn,
                      seed=seed if seed is not None
                      else getattr(opts, "seed", None),
                      num_workers=getattr(opts, "loader_workers", 1)
                      if is_train else 1)


def load_dataset(all_img_dbs: ImageDbGroup,
                 txt_dbs: Union[str, List[str]],
                 img_dbs: Union[str, List[str]], args, is_train: bool, *,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None):
    """trainer.py:193-209. The training DBs shard rank-strided over the
    processes of the group (trainer_utils.py:65-76); ``rank`` and
    ``world_size`` override the group's."""
    if is_train:
        rank = process_index() if rank is None else rank
        world_size = process_count() if world_size is None else world_size
        datasets = []
        for txt_path, img_path in zip(txt_dbs, img_dbs):
            img_db = all_img_dbs[img_path]
            # rank-strided data sharding (data.py:185-187); eval DBs stay
            # complete per process (recall is computed locally)
            txt_db = TxtTokDb(txt_path, args.max_txt_len, rank=rank,
                              world_size=world_size)
            datasets.append(ItmFastDataset(
                txt_db, img_db, args.num_hard_negatives,
                getattr(args, "img_meta_dict", None),
                getattr(args, "tokenizer", None)))
        return ConcatDataset(datasets)
    img_db = all_img_dbs[img_dbs]
    txt_db = TxtTokDb(txt_dbs, -1)
    return ItmFastDataset(txt_db, img_db, args.inf_minibatch_size,
                          getattr(args, "img_meta_dict", None),
                          getattr(args, "tokenizer", None))
