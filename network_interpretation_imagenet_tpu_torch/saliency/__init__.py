"""The masked-forward engine, the per-image saliency pipelines, the BO
explanation and the attribution family (gradients, occlusion, RISE, CAMs,
XRAI, learned masks), its fidelity metrics and sanity checks."""
