"""Demo captioning on a folder of images, ported from prismer_tpu/cli/
demo.py (reference: demo.py).

  python -m prismer_tpu_torch.cli.demo --exp_name exp --pretrained <ckpt> \\
      [--config prismer_tpu/configs/caption.yaml] [--device cuda|cpu]

Reads the images under the 'demo' entry's data_path (<data_path>/<dir>/
*.jpg|png|jpeg) with their expert labels under label_path (run the expert
generators first, prismer_tpu_torch.experts.generate), one image at a time.
Writes a .txt caption beside each image and prints `path: caption`
(demo.py:62-76).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from prismer_tpu_torch.cli import common
from prismer_tpu_torch.data import create_dataset, create_loader
from prismer_tpu_torch.models import caption as caption_head


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = common.base_parser("caption")
    p.set_defaults(target_dataset="demo")
    args = common.parse_args(p, argv)
    config, cfg, model, tokenizer = common.setup(args, "caption")

    _, test_ds = create_dataset("caption", config)
    loader = create_loader(test_ds, batch_size=1, num_workers=4, train=False,
                           **common.loader_shard())
    if args.pretrained:
        common.load_pretrained(args.pretrained, cfg, model)

    generate = caption_head.build_generate_fn(model)
    prefix = config.get("prefix", "")
    for batch in loader:
        experts = common.experts_to_device(batch["experts"], args.device)
        cap = caption_head.generate_captions(generate, experts, tokenizer,
                                             prefix)[0]
        img_path = test_ds.data_list[int(batch["index"][0])]["image"]
        out_path = os.path.splitext(img_path)[0] + ".txt"
        with open(out_path, "w") as f:
            f.write(cap)
        print(f"{img_path}: {cap}")


if __name__ == "__main__":
    main()
