"""evals_per_s: masked forwards a second of the ResNet-101 and Wide-ResNet-50-2 streams of 1,024 windows an image."""

from portbench.readers import evals_per_s as read  # noqa: F401
