"""The masked-forward engine and the per-image saliency pipeline."""
