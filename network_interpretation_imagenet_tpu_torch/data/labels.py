"""Class-name tables (port of ``data/labels.py``).

ImageNet names load from the dataset's own ``LOC_synset_mapping.txt``, with
a ``class_{i}`` fallback."""

from __future__ import annotations

import os
from typing import Dict, Optional

CIFAR10_CLASSES = (
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
)

MNIST_CLASSES = tuple(str(i) for i in range(10))


def load_imagenet_class_names(data_dir: Optional[str]) -> Dict[int, str]:
    """idx -> human-readable name, in the label order of
    ``ImagenetLocalizationDataset`` (sorted synsets)."""
    if data_dir:
        for candidate in (
            os.path.join(data_dir, "LOC_synset_mapping.txt"),
            os.path.join(os.path.dirname(data_dir.rstrip("/")), "LOC_synset_mapping.txt"),
        ):
            if os.path.exists(candidate):
                synset_to_name = {}
                with open(candidate) as f:
                    for line in f:
                        parts = line.strip().split(" ", 1)
                        if len(parts) == 2:
                            synset_to_name[parts[0]] = parts[1]
                return {i: synset_to_name[s] for i, s in enumerate(sorted(synset_to_name))}
    return {}


def class_name(label: int, dataset: str, names: Optional[Dict[int, str]] = None) -> str:
    if dataset.startswith("cifar10") and not dataset.startswith("cifar100"):
        return CIFAR10_CLASSES[label] if 0 <= label < 10 else f"class_{label}"
    if dataset == "mnist":
        return MNIST_CLASSES[label] if 0 <= label < 10 else f"class_{label}"
    if names and label in names:
        return names[label]
    return f"class_{label}"
