import sys

from kubernetes_scheduler_tpu_torch.cli import main

sys.exit(main())
