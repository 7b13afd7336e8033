"""The benchmark of ``network_interpretation_imagenet_tpu_torch`` on the card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout; see ``portbench/README.md``."""
