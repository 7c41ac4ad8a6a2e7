"""Task datasets, ported from prismer_tpu/data/datasets.py (reference:
dataset/{caption,vqa,pretrain,classification}_dataset.py).

Each dataset is a plain indexable object returning numpy records; batching /
prefetch lives in data/loader.py. File-list construction mirrors the
reference exactly (COCO-Karpathy JSONs, VQAv2+VG QA JSONs, CC12M/CC3M shard
globs with sidecar .txt captions, few-shot ImageNet folders, demo glob)."""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List

import numpy as np

from prismer_tpu_torch.data.features import get_feature_tables
from prismer_tpu_torch.data.labels import (build_expert_record,
                                           load_expert_labels)
from prismer_tpu_torch.data.text import pre_caption, pre_question
from prismer_tpu_torch.data.transform import Transform


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


class _Base:
    def __len__(self):
        return len(self.data_list)


class Caption(_Base):
    """COCO-Karpathy / NoCaps / demo-glob captioning
    (caption_dataset.py:15-62)."""

    def __init__(self, config: Dict[str, Any], train: bool = True):
        self.data_path = config["data_path"]
        self.label_path = config["label_path"]
        self.experts = config["experts"]
        self.prefix = config.get("prefix", "")
        self.dataset = config["dataset"]
        self.train = train
        self.transform = Transform(
            resize_resolution=config["image_resolution"],
            scale_size=(0.5, 1.0), train=train)
        self.tables = get_feature_tables() if self.experts != "none" else None

        if train:
            # only COCO/NoCaps have a training split (caption_dataset.py:27-30)
            self.data_list = []
            if self.dataset in ("coco", "nocaps"):
                self.data_list = load_json(os.path.join(
                    self.data_path, "coco_karpathy_train.json"))
        elif self.dataset == "coco":
            self.data_list = load_json(os.path.join(
                self.data_path, "coco_karpathy_test.json"))
        elif self.dataset == "nocaps":
            self.data_list = load_json(os.path.join(
                self.data_path, "nocaps_val.json"))
        elif self.dataset == "demo":
            folders = glob.glob(f"{self.data_path}/*/")
            self.data_list = [
                {"image": p} for f in folders for pat in
                ("*.jpg", "*.png", "*.jpeg") for p in glob.glob(f + pat)]
        else:
            raise ValueError(self.dataset)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        data = self.data_list[index]
        if self.dataset == "demo":
            parts = data["image"].split("/")
            img_name = parts[-2] + "/" + parts[-1]
            # demo images live at <data_path>/<subdir>/<img>; the label tree
            # keys them under the data_path's basename ('helpers')
            root = self.data_path.rstrip("/")
            image, labels, info = load_expert_labels(
                os.path.dirname(root), self.label_path, img_name,
                os.path.basename(root), self.experts)
        else:
            source = "vqav2" if self.dataset == "coco" else "nocaps"
            image, labels, info = load_expert_labels(
                self.data_path, self.label_path, data["image"], source,
                self.experts)
        experts = build_expert_record(self.transform(image, labels), info,
                                      self.tables)
        if self.train:
            caption = pre_caption(
                self.prefix + " " + data["caption"], max_words=30)
            return {"experts": experts, "caption": caption}
        return {"experts": experts, "index": index}


class VQA(_Base):
    """VQAv2 (+VG-QA) question answering (vqa_dataset.py:11-51)."""

    VG_WEIGHT = 0.2  # vqa_dataset.py:46

    def __init__(self, config: Dict[str, Any], train: bool = True):
        self.data_path = config["data_path"]
        self.label_path = config["label_path"]
        self.experts = config["experts"]
        self.train = train
        self.transform = Transform(
            resize_resolution=config["image_resolution"],
            scale_size=(0.5, 1.0), train=train)
        self.tables = get_feature_tables() if self.experts != "none" else None

        if train:
            self.data_list = []
            if "vqav2" in config["datasets"]:
                self.data_list += load_json(os.path.join(
                    self.data_path, "vqav2_train_val.json"))
            if "vg" in config["datasets"]:
                self.data_list += load_json(os.path.join(
                    self.data_path, "vg_qa.json"))
        else:
            self.data_list = load_json(os.path.join(
                self.data_path, "vqav2_test.json"))
            self.answer_list = load_json(os.path.join(
                self.data_path, "answer_list.json"))

    def __getitem__(self, index: int) -> Dict[str, Any]:
        data = self.data_list[index]
        source = "vqav2" if data["dataset"] == "vqa" else "vg"
        image, labels, info = load_expert_labels(
            self.data_path, self.label_path, data["image"], source,
            self.experts)
        experts = build_expert_record(self.transform(image, labels), info,
                                      self.tables)
        question = pre_question(data["question"], max_words=30)
        if self.train:
            weight = (np.float32(self.VG_WEIGHT) if data["dataset"] == "vg"
                      else np.float32(data["weight"]))
            return {"experts": experts, "question": question,
                    "answer": data["answer"], "weight": weight}
        return {"experts": experts, "index": index, "question": question,
                "question_id": data["question_id"]}


class Pretrain(_Base):
    """CC12M + CC3M-SGU + COCO + VG caption pretraining corpus
    (pretrain_dataset.py:13-73)."""

    def __init__(self, config: Dict[str, Any]):
        self.config = config
        self.label_path = config["label_path"]
        self.experts = config["experts"]
        self.transform = Transform(
            resize_resolution=config["image_resolution"],
            scale_size=(0.5, 1.5), train=True)
        self.tables = get_feature_tables() if self.experts != "none" else None

        self.data_list: List[Dict[str, Any]] = []
        if "cc12m" in config["datasets"]:
            for f in glob.glob(f"{config['cc12m_data_path']}/cc12m/*/"):
                self.data_list += [{"image": p} for p in glob.glob(f + "*.jpg")]
        if "cc3m_sgu" in config["datasets"]:
            for f in glob.glob(f"{config['cc3m_data_path']}/cc3m_sgu/*/"):
                self.data_list += [{"image": p} for p in glob.glob(f + "*.jpg")]
        if "coco" in config["datasets"]:
            self.data_list += load_json(os.path.join(
                config["coco_data_path"], "coco_karpathy_train.json"))
        if "vg" in config["datasets"]:
            self.data_list += load_json(os.path.join(
                config["vg_data_path"], "vg_caption.json"))

    def __getitem__(self, index: int) -> Dict[str, Any]:
        cfg = self.config
        img_path = self.data_list[index]["image"]
        if "cc12m" in img_path or "cc3m_sgu" in img_path:
            corpus = "cc12m" if "cc12m" in img_path else "cc3m_sgu"
            root = cfg[f"{'cc12m' if corpus == 'cc12m' else 'cc3m'}_data_path"]
            parts = img_path.split("/")
            img_name = parts[-2] + "/" + parts[-1]
            image, labels, info = load_expert_labels(
                root, self.label_path, img_name, corpus, self.experts)
            with open(img_path.replace(".jpg", ".txt")) as f:
                caption = f.readlines()[0]
        elif "train2014" in img_path or "val2014" in img_path:
            image, labels, info = load_expert_labels(
                cfg["coco_data_path"], self.label_path, img_path, "vqav2",
                self.experts)
            caption = self.data_list[index]["caption"]
        else:  # visual genome
            parts = img_path.split("/")
            img_name = parts[-2] + "/" + parts[-1]
            image, labels, info = load_expert_labels(
                cfg["vg_data_path"], self.label_path, img_name, "vg",
                self.experts)
            caption = self.data_list[index]["caption"]
        experts = build_expert_record(self.transform(image, labels), info,
                                      self.tables)
        return {"experts": experts,
                "caption": pre_caption(caption, max_words=30)}


class Classification(_Base):
    """Few-shot ImageNet via caption+rank (classification_dataset.py:12-58)."""

    def __init__(self, config: Dict[str, Any], train: bool = True):
        self.data_path = config["data_path"]
        self.label_path = config["label_path"]
        self.experts = config["experts"]
        self.prefix = config.get("prefix", "")
        self.train = train
        # NOTE: the reference uses train-mode augmentation for eval too
        # (classification_dataset.py:22) — replicated
        self.transform = Transform(
            resize_resolution=config["image_resolution"],
            scale_size=(0.5, 1.0), train=True)
        self.tables = get_feature_tables() if self.experts != "none" else None

        split = "imagenet_train" if train else "imagenet"
        folders = glob.glob(f"{self.data_path}/{split}/*/")
        shots = config.get("shots", 1)
        self.data_list = [
            {"image": p} for f in folders
            for p in (glob.glob(f + "*.JPEG")[:shots] if train
                      else glob.glob(f + "*.JPEG"))]
        self.answer_list = load_json(
            f"{self.data_path}/imagenet/imagenet_answer.json")
        self.class_list = load_json(
            f"{self.data_path}/imagenet/imagenet_class.json")
        self.split = split

    def __getitem__(self, index: int) -> Dict[str, Any]:
        img_path = self.data_list[index]["image"]
        parts = img_path.split("/")
        img_name = parts[-2] + "/" + parts[-1]
        class_name = parts[-2]
        image, labels, info = load_expert_labels(
            self.data_path, self.label_path, img_name, self.split,
            self.experts)
        experts = build_expert_record(self.transform(image, labels), info,
                                      self.tables)
        if self.train:
            caption = (self.prefix + " "
                       + self.answer_list[int(self.class_list[class_name])]
                       .lower())
            return {"experts": experts, "caption": caption}
        return {"experts": experts, "label": int(self.class_list[class_name])}


def create_dataset(task: str, config: Dict[str, Any]):
    """Factory (dataset/__init__.py:15-32)."""
    if task == "pretrain":
        return Pretrain(config)
    cls = {"vqa": VQA, "caption": Caption,
           "classification": Classification}[task]
    return cls(config, train=True), cls(config, train=False)
