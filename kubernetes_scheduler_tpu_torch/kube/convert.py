"""v1.Pod / v1.Node JSON -> host types.

The reference consumes these through client-go structs and schedutil
(CalculatePodResourceRequest, score/algorithm.go:238-262 reads
container/initContainer requests + overhead); here the same fields are
extracted from raw API JSON into host.types objects, with quantities
canonicalized the way the snapshot builder expects (cpu in millicores,
memory/storage in bytes, counts as floats).

Documented simplifications (each is a capability note, not an accident):
- node-affinity `matchExpressions` AND `matchFields` (metadata.name
  selectors — the snapshot synthesizes a `metadata.name` label per
  node) carry full upstream OR-of-ANDs term semantics (pod_from_api).
- pod-(anti)affinity and spread label selectors support matchLabels AND
  matchExpressions (host/types.labels_match) with upstream namespace
  scoping (own namespace by default, explicit `namespaces` honored;
  a non-empty namespaceSelector resolves EXACTLY against the live
  namespace set via resolve_namespace_selectors — the k8s >= 1.21
  union-with-explicit-list semantics; only when namespace data is
  unavailable does it degrade to ALL namespaces, logged); spread
  carries both whenUnsatisfiable modes (DoNotSchedule hard,
  ScheduleAnyway soft).
- GPU cards come from the SCV CRD in the reference (filter.go:8); the
  core API carries no card inventory, so nodes converted here have no
  cards unless an SCV-style annotation ("scv/cards": JSON list) is set.

The port's copy of kubernetes_scheduler_tpu/kube/convert.py.
"""

from __future__ import annotations

import json
import logging

from kubernetes_scheduler_tpu_torch.host.types import (
    Card,
    Container,
    MatchExpression,
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    PodAffinityTerm,
    SpreadConstraint,
    Taint,
    Toleration,
    WeightedExpression,
    parse_cpu_milli,
    parse_quantity,
)

log = logging.getLogger("yoda_tpu.kube")

BYTES_RESOURCES = ("memory", "ephemeral-storage", "storage")


def _requests(resources: dict | None) -> dict[str, float]:
    reqs = (resources or {}).get("requests") or {}
    out: dict[str, float] = {}
    for name, q in reqs.items():
        if name == "cpu":
            out[name] = parse_cpu_milli(q)
        else:
            out[name] = parse_quantity(q)
    return out


def _container(c: dict) -> Container:
    return Container(
        requests=_requests(c.get("resources")), image=c.get("image") or ""
    )


def _match_expr(e: dict) -> MatchExpression:
    return MatchExpression(
        key=e["key"], operator=e["operator"], values=list(e.get("values") or [])
    )


def _term_namespaces(
    term: dict, own_namespace: str
) -> tuple[list[str] | None, tuple | None]:
    """Upstream PodAffinityTerm namespace scope -> (namespaces,
    namespace_selector). `{}` as namespaceSelector selects ALL
    namespaces (None); a NON-empty selector is captured as
    (match_labels, match_expressions) for
    `resolve_namespace_selectors` to union with the explicit list
    against the live namespace set — exact k8s >= 1.21 semantics.
    Without a selector:
    the explicit list, or the owning pod's own namespace."""
    sel = term.get("namespaceSelector")
    if sel is not None:
        if sel:
            captured = (
                dict(sel.get("matchLabels") or {}),
                [_match_expr(e) for e in sel.get("matchExpressions") or []],
            )
            return list(term.get("namespaces") or []), captured
        return None, None  # {} = all namespaces (exact)
    if term.get("namespaces"):
        return list(term["namespaces"]), None
    return [own_namespace], None


def resolve_namespace_selectors(
    pod: Pod, namespace_labels: dict[str, dict] | None
) -> Pod:
    """Resolve every pod-affinity term's namespaceSelector against the
    live namespace set (name -> labels): term.namespaces becomes the
    UNION of the explicit entries and the selector-matched namespaces —
    upstream InterPodAffinity's namespace scoping. A selector matching
    nothing (and no explicit entries) leaves an empty list, which
    matches no pods: required affinity is then unsatisfiable and anti
    trivially satisfied, as upstream.

    namespace_labels=None means no namespace data is available (informer
    unavailable / RBAC missing): degrade to the ALL-namespaces
    approximation, logged — over-admits affinity and over-constrains
    anti-affinity, the conservative pre-informer stance."""
    import dataclasses

    if not any(t.namespace_selector for t in pod.pod_affinity):
        return pod
    terms = []
    for t in pod.pod_affinity:
        if not t.namespace_selector:
            terms.append(t)
            continue
        if namespace_labels is None:
            log.warning(
                "pod %s/%s: no namespace data; namespaceSelector "
                "approximated as ALL namespaces",
                pod.namespace, pod.name,
            )
            terms.append(dataclasses.replace(t, namespaces=None))
            continue
        from kubernetes_scheduler_tpu_torch.host.types import labels_match

        ml, mx = t.namespace_selector
        matched = {
            name
            for name, labels in namespace_labels.items()
            if labels_match(labels, ml, mx)
        }
        terms.append(
            dataclasses.replace(
                t, namespaces=sorted(matched | set(t.namespaces or ()))
            )
        )
    return dataclasses.replace(pod, pod_affinity=terms)


def _pod_affinity_terms(
    spec: dict, *, anti: bool, namespace: str
) -> list[PodAffinityTerm]:
    sect = (spec.get("affinity") or {}).get(
        "podAntiAffinity" if anti else "podAffinity"
    ) or {}
    out: list[PodAffinityTerm] = []

    def selector(term):
        sel = term.get("labelSelector") or {}
        labels = dict(sel.get("matchLabels") or {})
        exprs = [_match_expr(e) for e in sel.get("matchExpressions") or []]
        return (labels, exprs) if labels or exprs else None

    for term in sect.get("requiredDuringSchedulingIgnoredDuringExecution") or []:
        got = selector(term)
        if got:
            ns, ns_sel = _term_namespaces(term, namespace)
            out.append(
                PodAffinityTerm(
                    match_labels=got[0],
                    match_expressions=got[1],
                    topology_key=term.get("topologyKey", "kubernetes.io/hostname"),
                    anti=anti,
                    namespaces=ns,
                    namespace_selector=ns_sel,
                )
            )
    for wt in sect.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
        term = wt.get("podAffinityTerm") or {}
        got = selector(term)
        if got:
            ns, ns_sel = _term_namespaces(term, namespace)
            out.append(
                PodAffinityTerm(
                    match_labels=got[0],
                    match_expressions=got[1],
                    topology_key=term.get("topologyKey", "kubernetes.io/hostname"),
                    anti=anti,
                    preferred=True,
                    weight=int(wt.get("weight", 1)),
                    namespaces=ns,
                    namespace_selector=ns_sel,
                )
            )
    return out


def pod_from_api(obj: dict) -> Pod:
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    node_aff = (spec.get("affinity") or {}).get("nodeAffinity") or {}
    # upstream semantics: `nodeSelector` (a plain AND map) and
    # `nodeSelectorTerms` (OR of AND-lists) must BOTH pass. The host model
    # is a flat expression list with per-expression OR-group ids
    # (MatchExpression.term: AND within a group, OR across groups), so
    # the nodeSelector conjunct is replicated into every term — exactly
    # "nodeSelector AND (term_0 OR term_1 OR ...)". A term with no
    # matchExpressions matches NOTHING upstream ("a null or empty node
    # selector term matches no objects"): encoded as In with an empty
    # value set, which no node satisfies.
    ns_exprs: list[MatchExpression] = [
        MatchExpression(key=k, operator="In", values=[v])
        for k, v in (spec.get("nodeSelector") or {}).items()
    ]
    terms = (
        node_aff.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
    ).get("nodeSelectorTerms") or []
    required: list[MatchExpression] = []
    if terms:
        for t_i, term in enumerate(terms):
            # matchFields (metadata.name selectors) evaluate through the
            # same expression kernel: the snapshot synthesizes a
            # `metadata.name` label per node
            t_exprs = [
                _match_expr(e)
                for e in (term.get("matchExpressions") or [])
                + (term.get("matchFields") or [])
            ]
            if not t_exprs:
                t_exprs = [MatchExpression(key="", operator="In", values=[])]
            t_exprs += [
                MatchExpression(key=x.key, operator=x.operator, values=list(x.values))
                for x in ns_exprs
            ]
            for e in t_exprs:
                e.term = t_i
                required.append(e)
    else:
        required = ns_exprs
    # preferred terms keep upstream weighted-AND-list semantics: every
    # expression of a preference entry shares one group id, so the weight
    # is granted once iff the whole entry matches. Group ids are DENSE
    # over non-empty entries (an empty entry must not shift later ids
    # past the builder's expression-count bound)
    preferred: list[WeightedExpression] = []
    t_dense = 0
    for wt in node_aff.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
        pref = wt.get("preference") or {}
        exprs = (pref.get("matchExpressions") or []) + (
            pref.get("matchFields") or []
        )
        if not exprs:
            continue
        for e in exprs:
            preferred.append(
                WeightedExpression(
                    expr=_match_expr(e),
                    weight=int(wt.get("weight", 1)),
                    term=t_dense,
                )
            )
        t_dense += 1
    spread = [
        SpreadConstraint(
            match_labels=dict(
                (c.get("labelSelector") or {}).get("matchLabels") or {}
            ),
            match_expressions=[
                _match_expr(e)
                for e in (c.get("labelSelector") or {}).get("matchExpressions")
                or []
            ],
            topology_key=c.get("topologyKey", "kubernetes.io/hostname"),
            max_skew=int(c.get("maxSkew", 1)),
            # ScheduleAnyway = a soft score term (engine soft spread);
            # DoNotSchedule = a hard filter
            soft=c.get("whenUnsatisfiable", "DoNotSchedule") == "ScheduleAnyway",
            # upstream spread selectors match only the pod's own namespace
            namespaces=[meta.get("namespace", "default")],
        )
        for c in spec.get("topologySpreadConstraints") or []
        if (c.get("labelSelector") or {}).get("matchLabels")
        or (c.get("labelSelector") or {}).get("matchExpressions")
    ]
    host_ports = [
        int(p["hostPort"])
        for c in spec.get("containers") or []
        for p in c.get("ports") or []
        if p.get("hostPort")
    ]
    volume_claims = [
        v["persistentVolumeClaim"]["claimName"]
        for v in spec.get("volumes") or []
        if (v.get("persistentVolumeClaim") or {}).get("claimName")
    ]
    node_name = spec.get("nodeName") or None
    status = obj.get("status") or {}
    phase = status.get("phase", "")
    start_time = None
    raw_start = status.get("startTime")
    if raw_start:
        try:
            import datetime

            start_time = datetime.datetime.fromisoformat(
                raw_start.replace("Z", "+00:00")
            ).timestamp()
        except ValueError:
            log.warning(
                "pod %s: unparsable status.startTime %r", meta.get("name"),
                raw_start,
            )
    return Pod(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        uid=meta.get("uid"),
        labels=dict(meta.get("labels") or {}),
        annotations=dict(meta.get("annotations") or {}),
        containers=[_container(c) for c in spec.get("containers") or []],
        init_containers=[_container(c) for c in spec.get("initContainers") or []],
        overhead=_requests({"requests": spec.get("overhead") or {}}),
        tolerations=[
            Toleration(
                key=t.get("key"),
                value=t.get("value", ""),
                operator=t.get("operator", "Equal"),
                effect=t.get("effect", ""),
            )
            for t in spec.get("tolerations") or []
        ],
        node_affinity=required,
        pod_affinity=(
            _pod_affinity_terms(
                spec, anti=False, namespace=meta.get("namespace", "default")
            )
            + _pod_affinity_terms(
                spec, anti=True, namespace=meta.get("namespace", "default")
            )
        ),
        preferred_node_affinity=preferred,
        topology_spread=spread,
        # a PENDING pod carrying spec.nodeName is pinned (upstream
        # NodeName filter); once running the same field records placement
        target_node=node_name if phase in ("", "Pending") else None,
        host_ports=host_ports,
        node_name=node_name,
        scheduler_name=spec.get("schedulerName", "default-scheduler"),
        start_time=start_time,
        volume_claims=volume_claims,
        # spec.priority is the API-server-resolved PriorityClass value;
        # host/queue.pod_priority prefers it over the scv/priority label
        priority=spec.get("priority"),
        owner=next(
            (
                (o.get("kind", ""), o.get("name", ""))
                for o in meta.get("ownerReferences") or []
                if o.get("controller")
            ),
            None,
        ),
    )


# topology labels the VolumeZone family matches between a PV and nodes
_ZONE_LABELS = (
    "topology.kubernetes.io/zone",
    "topology.kubernetes.io/region",
    "failure-domain.beta.kubernetes.io/zone",
    "failure-domain.beta.kubernetes.io/region",
)


def pv_from_api(obj: dict) -> PersistentVolume:
    """PV -> scheduling constraint: spec.nodeAffinity.required terms
    (local volumes) with the PV's zone/region labels (VolumeZone) ANDed
    into every term — exactly how the pod-side OR-of-ANDs conversion
    treats nodeSelector. A PV with neither contributes no constraint."""
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    raw_terms = (
        (spec.get("nodeAffinity") or {}).get("required") or {}
    ).get("nodeSelectorTerms") or []
    terms: list[list[MatchExpression]] = []
    for t in raw_terms:
        exprs = [_match_expr(e) for e in t.get("matchExpressions") or []]
        if not exprs:
            exprs = [MatchExpression(key="", operator="In", values=[])]
        terms.append(exprs)
    zone_exprs = [
        MatchExpression(key=k, operator="In", values=[v])
        for k, v in (meta.get("labels") or {}).items()
        if k in _ZONE_LABELS
    ]
    if zone_exprs:
        terms = (
            [t + zone_exprs for t in terms] if terms else [zone_exprs]
        )
    return PersistentVolume(
        name=meta.get("name", ""),
        terms=terms,
        csi_driver=((spec.get("csi") or {}).get("driver") or ""),
    )


def pvc_from_api(obj: dict) -> PersistentVolumeClaim:
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    return PersistentVolumeClaim(
        namespace=meta.get("namespace", "default"),
        name=meta.get("name", ""),
        volume_name=spec.get("volumeName") or None,
        access_modes=list(spec.get("accessModes") or []),
        storage_class=spec.get("storageClassName") or None,
        selected_node=(meta.get("annotations") or {}).get(
            "volume.kubernetes.io/selected-node"
        ),
    )


def pdb_from_api(obj: dict) -> "PodDisruptionBudget":
    """policy/v1 PodDisruptionBudget JSON -> host type (matchLabels AND
    matchExpressions, with k8s label-selector operator semantics)."""
    from kubernetes_scheduler_tpu_torch.host.types import PodDisruptionBudget

    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    selector = spec.get("selector") or {}
    return PodDisruptionBudget(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        match_labels=dict(selector.get("matchLabels") or {}),
        match_expressions=[
            _match_expr(e) for e in selector.get("matchExpressions") or []
        ],
        min_available=spec.get("minAvailable"),
        max_unavailable=spec.get("maxUnavailable"),
        disruptions_allowed=status.get("disruptionsAllowed"),
    )


def node_from_api(obj: dict) -> Node:
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    allocatable: dict[str, float] = {}
    for name, q in (status.get("allocatable") or {}).items():
        allocatable[name] = (
            parse_cpu_milli(q) if name == "cpu" else parse_quantity(q)
        )
    cards: list[Card] = []
    raw = (meta.get("annotations") or {}).get("scv/cards")
    if raw:
        try:
            cards = [Card(**c) for c in json.loads(raw)]
        except (json.JSONDecodeError, TypeError) as e:
            log.warning("node %s: bad scv/cards annotation: %s", meta.get("name"), e)
    taints = [
        Taint(
            key=t["key"],
            value=t.get("value", ""),
            effect=t.get("effect", "NoSchedule"),
        )
        for t in spec.get("taints") or []
    ]
    # node.status.images -> ImageLocality input: every name alias of an
    # image entry maps to its size (upstream keys its image states by
    # every listed name too)
    images: dict[str, float] = {}
    for entry in status.get("images") or []:
        size = float(entry.get("sizeBytes") or 0)
        for alias in entry.get("names") or []:
            images[alias] = size
    # cordoned node (kubectl cordon sets spec.unschedulable): upstream's
    # NodeUnschedulable plugin filters it, tolerable via the well-known
    # taint key — expressed here as exactly that taint, so the existing
    # toleration machinery carries the semantics (a pod tolerating
    # node.kubernetes.io/unschedulable still lands, like upstream)
    if spec.get("unschedulable") and not any(
        t.key == "node.kubernetes.io/unschedulable" for t in taints
    ):
        taints.append(
            Taint(key="node.kubernetes.io/unschedulable", effect="NoSchedule")
        )
    return Node(
        name=meta.get("name", ""),
        labels=dict(meta.get("labels") or {}),
        taints=taints,
        allocatable=allocatable,
        cards=cards,
        images=images,
    )
