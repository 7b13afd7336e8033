"""Host-side data: the eval transform, the ImageNet-localization and
image-folder datasets, class names and a synthetic image."""
