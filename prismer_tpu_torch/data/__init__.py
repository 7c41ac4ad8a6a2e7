"""The port's data pipeline: files on disk (JPEG / PNG images, PNG expert
labels and their sidecars) -> transformed numpy records -> collated
batches -> tensors on the card, ported from prismer_tpu/data/."""

from prismer_tpu_torch.data.datasets import (Caption, Classification,
                                             Pretrain, VQA, create_dataset)
from prismer_tpu_torch.data.device import (experts_to_device,
                                           materialize_experts)
from prismer_tpu_torch.data.loader import DataLoader, create_loader
from prismer_tpu_torch.data.text import pre_caption, pre_question
from prismer_tpu_torch.data.transform import Transform

__all__ = ["Caption", "Classification", "Pretrain", "VQA", "create_dataset",
           "create_loader", "DataLoader", "Transform", "pre_caption",
           "pre_question", "materialize_experts", "experts_to_device"]
