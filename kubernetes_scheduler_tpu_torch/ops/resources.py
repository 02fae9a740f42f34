"""Resource-axis layout shared by every kernel and snapshot builder.

The reference scores five canonical resources (pkg/yoda/scheduler.go:55:
cpu, memory, pods, storage, ephemeral-storage) plus arbitrary scalar
("extended") resources (pkg/yoda/score/algorithm.go:224-228). We lay these
out as one dense resource axis: slots [0, N_CANONICAL) are canonical, slots
[N_CANONICAL, N_CANONICAL + n_extended) are extended resources whose meaning
is assigned per-snapshot by the host layer.

Units follow the reference:
  - CPU is in millicores (schedutil returns milli-values for cpu),
  - memory / storage / ephemeral-storage in bytes,
  - pods is a count,
  - extended resources are opaque integer quantities.
"""

from __future__ import annotations

RES_CPU = 0
RES_MEMORY = 1
RES_PODS = 2
RES_STORAGE = 3
RES_EPHEMERAL_STORAGE = 4
N_CANONICAL = 5

CANONICAL_NAMES = ("cpu", "memory", "pods", "storage", "ephemeral-storage")

# Non-zero defaults applied when a container specifies no request, matching
# k8s scheduler util semantics used by the reference's request math
# (pkg/yoda/score/algorithm.go:238-262 via schedutil.GetNonzeroRequestForResource).
DEFAULT_MILLI_CPU_REQUEST = 100            # 0.1 core
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024  # 200 MB


def total_slots(n_extended: int) -> int:
    return N_CANONICAL + int(n_extended)
