"""Typed cluster objects — the host-side stand-ins for the k8s API types
the reference consumes (v1.Pod, v1.Node, framework.NodeInfo, and the SCV
CRD's Card/Scv, pkg/yoda/filter/filter.go:8).

Deliberately minimal: only the fields the scheduling capabilities touch.
String quantities use plain floats in canonical units (cpu millicores,
bytes, counts) — parsing of k8s quantity strings ("500m", "2Gi") is in
parse_quantity below.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def parse_quantity(q: str | int | float) -> float:
    """k8s resource.Quantity subset: '500m', '2Gi', '1.5', 4."""
    if isinstance(q, (int, float)):
        return float(q)
    s = q.strip()
    suffixes = {
        "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
        "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15,
    }
    if s.endswith("m"):
        return float(s[:-1]) / 1000.0
    for suf, mult in suffixes.items():
        if s.endswith(suf):
            return float(s[: -len(suf)]) * mult
    return float(s)


def parse_cpu_milli(q: str | int | float) -> float:
    """CPU quantity to millicores ('500m' -> 500, 2 -> 2000)."""
    if isinstance(q, str) and q.strip().endswith("m"):
        return float(q.strip()[:-1])
    return parse_quantity(q) * 1000.0


@dataclass
class Container:
    requests: dict[str, float] = field(default_factory=dict)  # canonical units
    # container image reference (upstream ImageLocality scoring input);
    # "" = unknown/absent
    image: str = ""


@dataclass
class Toleration:
    key: str | None = None   # None = empty key (wildcard with Exists)
    value: str = ""
    operator: str = "Equal"  # "Equal" | "Exists"
    effect: str = ""         # "" = all effects


@dataclass
class MatchExpression:
    key: str
    operator: str            # In | NotIn | Exists | DoesNotExist
    values: list[str] = field(default_factory=list)
    # OR-group id for required node affinity: upstream nodeSelectorTerms
    # are OR-of-AND-lists — a node passes if, for SOME term id, every
    # expression carrying that id matches (kube/convert.pod_from_api
    # assigns ids; the flat default 0 keeps a plain AND list)
    term: int = 0


def labels_match(
    labels: dict[str, str],
    match_labels: dict[str, str],
    match_expressions: list["MatchExpression"] = (),
) -> bool:
    """k8s label-selector semantics: every matchLabels pair AND every
    matchExpression must hold (missing key satisfies NotIn; an unknown
    operator fails closed). Shared by PDB selection and the snapshot
    builder's selector matching so the two cannot drift."""
    if not all(labels.get(k) == v for k, v in match_labels.items()):
        return False
    for e in match_expressions:
        has = e.key in labels
        val = labels.get(e.key)
        if e.operator == "In":
            if not has or val not in e.values:
                return False
        elif e.operator == "NotIn":
            if has and val in e.values:
                return False
        elif e.operator == "Exists":
            if not has:
                return False
        elif e.operator == "DoesNotExist":
            if has:
                return False
        else:
            return False
    return True


@dataclass
class PodAffinityTerm:
    match_labels: dict[str, str]
    topology_key: str = "kubernetes.io/hostname"
    anti: bool = False
    # preferredDuringSchedulingIgnoredDuringExecution: a score term with
    # this weight instead of a hard filter (engine.compute_soft_scores)
    preferred: bool = False
    weight: int = 1
    # labelSelector.matchExpressions, ANDed with match_labels
    match_expressions: list["MatchExpression"] = field(default_factory=list)
    # namespaces whose pods the selector may match. None = ALL
    # namespaces (host-API convenience and the namespaceSelector:{}
    # case); upstream's default — the owning pod's own namespace — is
    # what kube/convert fills in ([pod.namespace]) when the term
    # carries no explicit list
    namespaces: list[str] | None = None
    # a non-empty namespaceSelector (labels-selected namespaces,
    # k8s >= 1.21), stored as (match_labels, match_expressions) so
    # kube/convert.resolve_namespace_selectors can turn it into the
    # concrete list — upstream semantics: selector-matched namespaces
    # UNIONed with any explicit `namespaces` entries. None = no selector.
    namespace_selector: tuple | None = None


@dataclass
class SpreadConstraint:
    """topologySpreadConstraints entry: placements of pods matching the
    selector (match_labels AND match_expressions) may not skew across
    `topology_key` domains by more than `max_skew`. Skew here is measured
    against the minimum count over all schedulable nodes' domains (upstream
    additionally filters domains by the pod's node affinity — documented
    simplification).

    soft=False is DoNotSchedule (a hard filter); soft=True is
    ScheduleAnyway (a score term preferring less-skewed domains,
    engine.compute_soft_scores)."""

    match_labels: dict[str, str]
    topology_key: str = "kubernetes.io/hostname"
    max_skew: int = 1
    soft: bool = False
    match_expressions: list["MatchExpression"] = field(default_factory=list)
    # upstream spread selectors match only the pod's OWN namespace;
    # kube/convert fills [pod.namespace]. None = all namespaces
    # (host-API convenience, the pre-namespace behavior)
    namespaces: list[str] | None = None


@dataclass
class PodDisruptionBudget:
    """policy/v1 PodDisruptionBudget, the slice preemption consults
    (upstream PostFilter orders candidates by PDB violations; this
    framework's preemption never violates a budget — documented stricter
    deviation in ops/preempt.py's module docstring).

    min_available / max_unavailable accept ints or "N%" strings exactly
    like the API; disruptions_allowed, when set, is the server-computed
    status.disruptionsAllowed and takes precedence over the spec math.
    """

    name: str
    namespace: str = "default"
    match_labels: dict[str, str] = field(default_factory=dict)
    match_expressions: list["MatchExpression"] = field(default_factory=list)
    min_available: int | str | None = None
    max_unavailable: int | str | None = None
    disruptions_allowed: int | None = None

    def selects(self, pod: "Pod") -> bool:
        if pod.namespace != self.namespace:
            return False
        return labels_match(pod.labels, self.match_labels, self.match_expressions)

    def allowed(
        self, matching_count: int, expected_count: int | None = None
    ) -> int:
        """Evictions this budget permits given the current healthy count.

        Percentage budgets resolve against `expected_count` — the owning
        controllers' summed replica counts, as the upstream disruption
        controller computes it (host/scheduler resolves it through the
        informer-cached ReplicaSet/StatefulSet stores via the pods'
        ownerReferences). Narrowed deviation: when NO expected count is
        resolvable (controller-less pods, or no controller informer —
        simulated clusters), percentages fall back to the CURRENT
        matching count, which over-allows when replicas are already down
        (50% of 10 with 6 healthy: k8s allows 1, the fallback allows 3).
        Real clusters are doubly covered: the PDB controller maintains
        status.disruptionsAllowed, which takes precedence over all spec
        math."""
        if self.disruptions_allowed is not None:
            return max(0, int(self.disruptions_allowed))
        base = expected_count if expected_count is not None else matching_count

        def resolve(v) -> int:
            if isinstance(v, str) and v.endswith("%"):
                import math

                return math.ceil(base * float(v[:-1]) / 100.0)
            return int(v)

        if self.max_unavailable is not None:
            # upstream: healthy - (expected - maxUnavailable) — with
            # replicas already down, the missing ones count as
            # disruptions in flight (base == matching_count reduces to
            # the plain maxUnavailable resolve)
            desired_healthy = max(0, base - resolve(self.max_unavailable))
            return max(0, matching_count - desired_healthy)
        if self.min_available is not None:
            return max(0, matching_count - resolve(self.min_available))
        return matching_count  # no constraint given


@dataclass
class WeightedExpression:
    """One preferred node-affinity term: a weighted matchExpression
    (preferredDuringScheduling...; the upstream term's expression list is
    modeled as one expression per weighted term)."""

    expr: MatchExpression
    weight: int = 1
    # preferred-term group id: upstream preferred terms are weighted
    # AND-lists; expressions sharing a term id must ALL match for the
    # weight to be granted once. None = this expression is its own term.
    term: int | None = None


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    # metadata.uid: the identity that survives delete-and-recreate under
    # the same name; None for simulated pods (falls back to ns/name)
    uid: str | None = None
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    containers: list[Container] = field(default_factory=list)
    init_containers: list[Container] = field(default_factory=list)
    overhead: dict[str, float] = field(default_factory=dict)
    tolerations: list[Toleration] = field(default_factory=list)
    node_affinity: list[MatchExpression] = field(default_factory=list)
    pod_affinity: list[PodAffinityTerm] = field(default_factory=list)
    preferred_node_affinity: list[WeightedExpression] = field(default_factory=list)
    topology_spread: list[SpreadConstraint] = field(default_factory=list)
    # spec.nodeName: pin to one node (upstream NodeName filter)
    target_node: str | None = None
    # hostPorts requested by any container (upstream NodePorts filter);
    # encoded as capacity-1 pseudo-resource columns by the snapshot builder
    host_ports: list[int] = field(default_factory=list)
    node_name: str | None = None  # set once bound
    scheduler_name: str = "yoda-tpu"
    # status.startTime as epoch seconds; None = not started (treated as
    # newest, i.e. least important, in preemption victim ordering —
    # upstream GetPodStartTime's nil-means-now stance)
    start_time: float | None = None
    # PVC claim names referenced by spec.volumes (kube/volumes resolves
    # bound claims' PV topology into node_affinity before scheduling)
    volume_claims: list[str] = field(default_factory=list)
    # 'ns/name' keys of this pod's ReadWriteOncePod claims (set by
    # kube/volumes.fold): the scheduler serializes access per cycle —
    # upstream VolumeRestrictions' at-most-one-pod exclusivity
    exclusive_claims: list[str] = field(default_factory=list)
    # spec.priority (PriorityClass admission). None = unset: the queue
    # and batch builder then fall back to the reference's scv/priority
    # label (sort.go:12-18); when both exist the API-server-resolved
    # spec wins, matching upstream
    priority: int | None = None
    # attachable-volumes-csi-<driver> units this pod's bound CSI
    # volumes consume (kube/volumes.attach_demands; upstream
    # NodeVolumeLimits) — folded into the pod's request vector
    attach_demands: dict[str, float] = field(default_factory=dict)
    # the controller ownerReference as (kind, name) — e.g.
    # ("ReplicaSet", "web-7d4b9"); None = controller-less. Feeds the
    # PDB percentage math's expected-replica lookup (upstream disruption
    # controller semantics)
    owner: tuple | None = None


@dataclass
class PersistentVolume:
    """The scheduling-relevant slice of a PV: its node-affinity terms
    (spec.nodeAffinity.required — OR of AND-lists, local volumes) plus
    zone/region topology labels (legacy VolumeZone semantics), already
    folded into `terms` by kube/convert.pv_from_api. A pod bound to this
    PV may only run on nodes satisfying some term."""

    name: str
    terms: list[list[MatchExpression]] = field(default_factory=list)
    # spec.csi.driver — feeds NodeVolumeLimits: each bound CSI volume
    # consumes one attachable-volumes-csi-<driver> capacity unit on its
    # node. "" = not a CSI volume (no attach-limit accounting).
    csi_driver: str = ""


@dataclass
class PersistentVolumeClaim:
    """PVC binding state: volume_name is set once the claim is Bound.
    An unbound claim (WaitForFirstConsumer, or still pending binding)
    contributes no scheduling constraint — the volume follows the pod
    (constrain-at-bind), upstream VolumeBinding's WFFC stance.
    access_modes feeds the VolumeRestrictions check: a ReadWriteOncePod
    claim already in use keeps new pods pending."""

    namespace: str
    name: str
    volume_name: str | None = None
    access_modes: list[str] = field(default_factory=list)
    # spec.storageClassName — resolves the class's volumeBindingMode for
    # the WFFC selected-node handoff (VolumeBinding's active half)
    storage_class: str | None = None
    # volume.kubernetes.io/selected-node annotation, when already set
    # (idempotency: the binder does not re-PATCH it)
    selected_node: str | None = None


@dataclass
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclass
class Card:
    """GPU card, mirroring the SCV CRD status fields the reference filters
    and scores on (filter.go:52-58, algorithm.go:280-291)."""

    bandwidth: float = 0
    clock: float = 0
    core: float = 0
    power: float = 0
    free_memory: float = 0
    total_memory: float = 0
    health: str = "Healthy"


@dataclass
class Node:
    name: str
    labels: dict[str, str] = field(default_factory=dict)
    taints: list[Taint] = field(default_factory=list)
    allocatable: dict[str, float] = field(default_factory=dict)
    cards: list[Card] = field(default_factory=list)
    # container images present on the node: image reference -> sizeBytes
    # (node.status.images; every entry's name aliases share the size) —
    # upstream ImageLocality's input
    images: dict[str, float] = field(default_factory=dict)
