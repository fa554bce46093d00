"""Declarative operator graphs: :class:`Node` and :class:`Pipeline`.

A :class:`~repro_torch.core.process.Process` is wired with
:meth:`~repro_torch.core.process.Process.bind`, which maps its ports to
named edges, Data or registered handles, and returns a :class:`Node`::

    fft  = FFT(app).bind(infile="kspace", outfile="xspace",
                         params=FFTParams("backward", var="kdata"))
    prod = ComplexElementProd(app).bind(infile="xspace", outfile="weighted",
                                        smaps="smaps")
    comb = XImageSum(app).bind(infile="weighted", outfile="image")

    pipe = Pipeline(app) | fft | prod | comb                # linear
    pipe = Pipeline.from_graph(app, [fft, prod, comb], output="image")
    out = pipe.run({"kspace": kd, "smaps": sm})             # fan-in launch

Linear ``|`` composition auto-wires: a node without an ``in`` binding
consumes the previous node's output edge.  :meth:`Pipeline.from_graph`
takes nodes in any order and sorts them (Kahn), so forks and fan-in DAGs
need no particular order.  A secondary input port bound to a **named
edge** is a join: it reads that edge, and an edge that no node produces
becomes one more graph input (:attr:`Pipeline.input_edges`), which
``run`` takes as a ``{edge: Data}`` mapping or a tuple in that order.  A
secondary port bound to a Data or a handle is static (weights, a fixed
set of maps): it is read live at each launch, and a stream or a server
reads it unbatched for every item (``Process.set_aux_handle``).

``run`` has three modes: ``launch`` (one input set), ``stream`` (many,
batched and double-buffered through :mod:`repro_torch.core.stream`) and
``serve`` (many, as requests to a :class:`repro_torch.serve.pipeline.
PipelineServer`; :meth:`Pipeline.serve` makes a standing one).

Validation happens when the graph is composed or built, never at launch:

* an undeclared port, or concrete Data that violates a
  :class:`~repro_torch.core.process.Port`, raises ``PortError`` from
  ``bind()``;
* consuming an edge no node produces (linear ``|``), producing one edge
  twice, a cycle, more than one anonymous input, a join edge produced
  after it is consumed (linear ``|``), or an input mapping missing or
  naming an unknown edge raises :class:`GraphError`, naming the edges;
* shape/dtype mismatches between nodes, on a join edge too, raise
  ``PortError`` from ``build()``: each node's output specs come from
  :meth:`~repro_torch.core.process.Process.out_specs` (``apply`` on
  ``meta`` tensors unless the process states them), so nothing is
  allocated or run to reject a graph.

``build()`` then gives every graph input edge a buffer of its own,
allocates every other edge Data from the inferred specs, wires the
processes over arena handles (join ports to their edge's handle), and
runs their ``init()``.  The residency plan keeps graph input and output
edges on the host path and plans internal edges device-resident, as is a
``persistent`` Data (a decode state bound as both the input and the
output of a step).  The JAX package also donates an internal edge's
buffer to its single consumer (XLA's ``donate_argnums``); the port has no
counterpart and keeps every edge buffer, which is what lets a compiled
launch (a CUDA graph on the card) replay on the same blobs run after run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from .app import CLapp, DataHandle
from .data import Data
from .process import Port, PortError, Process, ProcessChain, ProfileParameters


class GraphError(ValueError):
    """The operator graph is mis-wired (unknown edge, two producers, a
    cycle, an ambiguous input, a join missing one of its input edges).
    Raised while the graph is composed or built, never at launch."""


def _is_edge(b: Any) -> bool:
    return isinstance(b, str)


def _is_data(b: Any) -> bool:
    return isinstance(b, Data)


def _is_handle(b: Any) -> bool:
    return isinstance(b, int) and not isinstance(b, bool)


class Node:
    """One bound operator: a Process plus its port bindings (made by
    :meth:`Process.bind`, which validates them at once).  A secondary port
    bound to an edge name is a join (``input_bind``); one bound to a Data
    or handle is static (``port_bind``)."""

    def __init__(self, process: Process, in_bind: Any = None, out_bind: Any = None,
                 port_bind: Optional[Dict[str, Any]] = None):
        self.process = process
        self.in_bind = in_bind
        self.out_bind = out_bind
        bindings = dict(port_bind or {})
        #: joins: secondary input port -> edge name
        self.input_bind: Dict[str, str] = {k: v for k, v in bindings.items() if _is_edge(v)}
        #: static bindings: secondary input port -> Data or handle
        self.port_bind: Dict[str, Any] = {k: v for k, v in bindings.items()
                                          if not _is_edge(v)}
        self.name = type(process).__name__
        self._validate()

    def _validate(self) -> None:
        ports = self.process.ports
        inputs = set(ports) - {"in", "out"}
        unknown = (set(self.port_bind) | set(self.input_bind)) - inputs
        if unknown:
            raise PortError(f"{self.name}.bind: no input port(s) named {sorted(unknown)}; "
                            f"declared input ports: {sorted(inputs)}")
        for slot, bind in (("in", self.in_bind), ("out", self.out_bind)):
            if not (bind is None or _is_edge(bind) or _is_data(bind) or _is_handle(bind)):
                raise PortError(f"{self.name}.bind: {slot!r} must be an edge name, a Data "
                                f"or a DataHandle, got {type(bind).__name__}")
        for pname, bind in self.port_bind.items():
            if not (_is_data(bind) or _is_handle(bind)):
                raise PortError(f"{self.name}.bind: port {pname!r} must be an edge name "
                                f"(a join), a Data or a DataHandle, got {type(bind).__name__}")
            if _is_data(bind):
                ports[pname].validate(bind.specs(), owner=self.name, port=pname)
        if _is_data(self.in_bind):
            ports["in"].validate(self.in_bind.specs(), owner=self.name, port="in")

    def __repr__(self):
        return (f"Node({self.name}, in={self.in_bind!r}, out={self.out_bind!r}, "
                f"joins={self.input_bind}, ports={sorted(self.port_bind)})")


@dataclasses.dataclass
class _Built:
    """State cached by :meth:`Pipeline.build`."""

    executor: Process                       # the single node's process, or a chain
    input_edges: Tuple[str, ...]            # graph input edges, primary first
    input_handles: Dict[str, DataHandle]    # input edge -> its own buffer's handle
    output_handle: DataHandle
    #: edge name -> 'host' (graph input/output edges) or 'device'
    #: (internal edges and persistent Data)
    residency: Dict[str, str]

    @property
    def input_order(self) -> Tuple[str, ...]:
        """The input edges in the order the executor streams its inputs
        (:meth:`Process.stream_inputs`): the order a stream or server item
        is passed in, each edge once."""
        h2e = {h: e for e, h in self.input_handles.items()}
        target = self.executor._stream_target()
        missing = [h for _, h in target.stream_inputs() if h not in h2e]
        if missing:
            raise GraphError(f"executor streams handles {missing} that are not graph input "
                             f"edges {list(self.input_edges)}; the join is mis-wired")
        return tuple(h2e[h] for _, h in target.stream_inputs())

    @property
    def input_handle(self) -> DataHandle:
        """The primary (first) input edge's handle."""
        return self.input_handles[self.input_edges[0]]


class Pipeline:
    """A validated DAG of bound operator nodes: ``Pipeline(app) | node``
    for a chain, :meth:`from_graph` for forks and fan-in joins.

    ``fuse=True`` runs the nodes as one ``ProcessChain(mode="fused")``
    (only the output edge is written; the output must come from the last
    node); the default is the staged chain.  ``output`` names the output
    edge when it is not the last node's."""

    def __init__(self, app: CLapp, nodes: Sequence[Node | Process] = (), *,
                 fuse: bool = False, output: Optional[str] = None,
                 _graph_input_edges: Optional[Sequence[str]] = None):
        self.app = app
        self.fuse = fuse
        self.nodes: List[Node] = [self._as_node(n) for n in nodes]
        self._requested_output = output
        # edges from_graph classified as graph inputs: a node other than the
        # first may consume one as its primary input (a fan-in root); linear
        # '|' composition keeps the stricter produced-upstream rule
        self._declared_inputs = set(_graph_input_edges or ())
        self._built: Optional[_Built] = None
        self._plan_edges()

    @staticmethod
    def _as_node(n: Node | Process) -> Node:
        if isinstance(n, Node):
            return n
        if isinstance(n, Process):
            return Node(n)
        raise GraphError(f"cannot compose {type(n).__name__} into a Pipeline "
                         "(expected Node or Process)")

    def __or__(self, other: Node | Process) -> "Pipeline":
        return Pipeline(self.app, self.nodes + [self._as_node(other)], fuse=self.fuse,
                        output=self._requested_output,
                        _graph_input_edges=self._declared_inputs)

    # ------------------------------------------------------------- planning
    def _plan_edges(self) -> None:
        """Name every node's input, join and output edges; reject mis-wiring.
        A join edge that no upstream node produces becomes another graph
        input edge."""
        self._in_edges: List[str] = []
        self._out_edges: List[str] = []
        self._join_edges: List[Dict[str, str]] = []   # per node: port -> edge
        self._input_edges: List[str] = []             # graph inputs, primary first
        self._input_data: Optional[Data] = None
        self._input_handle: Optional[DataHandle] = None
        self._output_bind: Any = None
        self._output_edge: Optional[str] = None
        if not self.nodes:
            return
        producers: Dict[str, int] = {}                # edge -> node, -1 = graph input
        last = len(self.nodes) - 1
        for i, node in enumerate(self.nodes):
            b = node.in_bind
            if i == 0:
                if _is_data(b):
                    self._input_data = b
                elif _is_handle(b):
                    self._input_handle = b
                edge = b if _is_edge(b) else "_in"
                self._input_edges.append(edge)
                producers[edge] = -1
            elif b is None:
                edge = self._out_edges[-1]
            elif _is_edge(b):
                if b not in producers:
                    if b not in self._declared_inputs:
                        raise GraphError(f"node {i} ({node.name}) consumes edge {b!r} which "
                                         "no upstream node produces (known edges: "
                                         f"{sorted(producers)})")
                    self._input_edges.append(b)    # another root of a fan-in DAG
                    producers[b] = -1
                edge = b
            else:
                raise GraphError(f"node {i} ({node.name}): only the first node may bind a "
                                 "concrete input Data/handle; bind a secondary input port "
                                 "to a named edge for another graph input (a join)")
            joins: Dict[str, str] = {}
            for pname, jedge in node.input_bind.items():
                if jedge not in producers:
                    self._input_edges.append(jedge)
                    producers[jedge] = -1
                joins[pname] = jedge
            out = node.out_bind
            if _is_data(out) or _is_handle(out):
                if i != last:
                    raise GraphError(f"node {i} ({node.name}): only the last node may bind "
                                     "a concrete output Data/handle")
                self._output_bind = out
                out_edge = "_out"
            else:
                out_edge = out if _is_edge(out) else f"_e{i}"
            if out_edge in producers:
                if producers[out_edge] == -1:
                    raise GraphError(
                        f"edge {out_edge!r} is consumed as a graph input edge upstream but "
                        f"produced by node {i} ({node.name}); in a linear '|' pipeline a "
                        "join edge must be produced before it is consumed: use "
                        "Pipeline.from_graph for order-independent wiring")
                raise GraphError(f"edge {out_edge!r} is produced twice: it has two producers "
                                 f"(node {producers[out_edge]} and node {i} ({node.name}))")
            producers[out_edge] = i
            self._in_edges.append(edge)
            self._join_edges.append(joins)
            self._out_edges.append(out_edge)
        requested = self._requested_output
        if requested is not None:
            if producers.get(requested, -1) < 0:
                raise GraphError(f"requested output edge {requested!r} is not produced by "
                                 "any node")
            self._output_edge = requested
        else:
            self._output_edge = self._out_edges[-1]
        if self.fuse and self._output_edge != self._out_edges[-1]:
            raise GraphError(f"fuse=True requires the output edge ({self._output_edge!r}) to "
                             "be produced by the last node; reorder the nodes or use the "
                             "staged chain")

    @classmethod
    def from_graph(cls, app: CLapp, nodes: Sequence[Node | Process], *,
                   output: Optional[str] = None, fuse: bool = False) -> "Pipeline":
        """A Pipeline from explicitly bound nodes forming a DAG over named
        edges, in any order (sorted here, the given order kept among nodes
        that are ready together).

        Every edge consumed (by an ``in`` binding or a join) and never
        produced is a graph input edge.  At most one node may leave its
        input anonymous (no ``in`` binding, or a Data/handle), since an
        anonymous input cannot be named in a ``run()`` mapping.  Cycles
        and duplicate producers raise :class:`GraphError` naming the edges.
        ``output`` selects the output edge; its producer is moved last when
        nothing consumes it (so ``fuse=True`` stays possible), unless it is
        the anonymous-input node, which stays first."""
        node_list = [cls._as_node(n) for n in nodes]
        produced: Dict[str, int] = {}
        for i, node in enumerate(node_list):
            out = node.out_bind
            edge = out if _is_edge(out) else f"_n{i}"
            if edge in produced:
                raise GraphError(f"edge {edge!r} has two producers (node {produced[edge]} and "
                                 f"node {i} ({node.name}))")
            produced[edge] = i

        anon: List[int] = []
        input_edges: List[str] = []
        deps: Dict[int, List[int]] = {i: [] for i in range(len(node_list))}
        for i, node in enumerate(node_list):
            b = node.in_bind
            if b is None or _is_data(b) or _is_handle(b):
                anon.append(i)
            elif b in produced:
                deps[i].append(produced[b])
            elif b not in input_edges:
                input_edges.append(b)
            for jedge in node.input_bind.values():
                if jedge in produced:
                    deps[i].append(produced[jedge])
                elif jedge not in input_edges:
                    input_edges.append(jedge)
        if len(anon) > 1:
            names = ", ".join(f"node {i} ({node_list[i].name})" for i in anon)
            raise GraphError(f"graph has more than one anonymous input ({names}); give each "
                             "input node a named 'in' edge so run() can address every input "
                             "edge by name")
        if anon and deps[anon[0]]:
            i = anon[0]
            raise GraphError(f"node {i} ({node_list[i].name}) leaves its 'in' binding "
                             "anonymous but joins produced edges "
                             f"{sorted(node_list[i].input_bind.values())}; name its 'in' edge "
                             "so the graph input can be addressed")

        # Kahn's order; the anonymous-input node goes first, as linear
        # planning gives the anonymous '_in' edge to node 0 only
        remaining = set(range(len(node_list)))
        order: List[int] = []
        while remaining:
            ready = [i for i in sorted(remaining) if all(d not in remaining for d in deps[i])]
            if not ready:
                names = sorted(node_list[i].name for i in remaining)
                edges = sorted({node_list[i].in_bind for i in remaining
                                if _is_edge(node_list[i].in_bind)}
                               | {e for i in remaining for e in node_list[i].input_bind.values()})
                raise GraphError(f"operator graph has a cycle through {names} (edges "
                                 f"involved: {edges})")
            if not order and anon and anon[0] in ready:
                ready.remove(anon[0])
                ready.insert(0, anon[0])
            order.extend(ready)
            remaining -= set(ready)
        if output is not None and output in produced:
            # never move the anonymous-input node: linear planning would
            # rewire its input to the previous node's output
            p = produced[output]
            consumed = any(n.in_bind == output or output in n.input_bind.values()
                           for n in node_list)
            if p not in anon and not consumed:
                order.remove(p)
                order.append(p)
        return cls(app, [node_list[i] for i in order], fuse=fuse, output=output,
                   _graph_input_edges=input_edges)

    # ---------------------------------------------------------------- build
    @property
    def input_edges(self) -> Tuple[str, ...]:
        """The graph's input edges, the primary one first."""
        return tuple(self._input_edges)

    @property
    def residency_plan(self) -> Dict[str, str]:
        if self._built is None:
            raise GraphError("pipeline not built yet")
        return dict(self._built.residency)

    def _example_inputs(self, inputs: Any) -> Dict[str, Data]:
        """One Data per graph input edge, from ``inputs`` (None, one Data, an
        ``{edge: Data}`` mapping, or a tuple in :attr:`input_edges` order)
        and the bound input Data/handle.  A missing or unknown edge raises
        :class:`GraphError` naming the edges."""
        edges = self._input_edges
        if isinstance(inputs, Mapping):
            unknown = [e for e in inputs if e not in edges]
            if unknown:
                raise GraphError(f"inputs name unknown edges {unknown}; this graph's input "
                                 f"edges are {edges}")
            mapping = dict(inputs)
        elif isinstance(inputs, (tuple, list)):
            if len(inputs) != len(edges):
                raise GraphError(f"inputs supply {len(inputs)} Data for {len(edges)} input "
                                 f"edges {edges} (a tuple follows Pipeline.input_edges)")
            mapping = dict(zip(edges, inputs))
        elif inputs is not None:
            if not _is_data(inputs):
                raise TypeError(f"Pipeline.run takes one Data, an {{edge: Data}} mapping or a "
                                f"tuple in launch mode, got {type(inputs).__name__}")
            if len(edges) > 1:
                raise GraphError(f"graph has input edges {edges}; pass one Data per edge as "
                                 "an {edge name: Data} mapping")
            mapping = {edges[0]: inputs}
        else:
            mapping = {}
        examples: Dict[str, Data] = {}
        for edge in edges:
            src = mapping.get(edge)
            if src is None and edge == edges[0]:
                src = self._input_data
                if src is None and self._input_handle is not None:
                    src = self.app.getData(self._input_handle)
            if src is None:
                raise GraphError(f"no Data for the input edge {edge!r}: bind it with infile= "
                                 f"or pass it in the inputs (input edges: {edges})")
            if not _is_data(src):
                raise TypeError(f"input edge {edge!r} takes a Data, got {type(src).__name__}")
            examples[edge] = src
        return examples

    def build(self, inputs: Any = None) -> _Built:
        """Validate every port against the inferred specs, allocate the edge
        Data, wire the processes and run their ``init()`` (once; cached).
        ``inputs`` is what :meth:`run` takes."""
        if self._built is not None:
            return self._built
        if not self.nodes:
            raise GraphError("cannot build an empty pipeline")
        app = self.app
        examples = self._example_inputs(inputs)

        # ---- validation: specs flow edge to edge, nothing is allocated ----
        edge_specs = {e: d.specs() for e, d in examples.items()}
        for i, node in enumerate(self.nodes):
            p = node.process
            in_specs = edge_specs[self._in_edges[i]]
            p.ports.get("in", Port()).validate(in_specs, owner=node.name, port="in")
            port_specs = {}
            for pname, port in p.ports.items():
                if pname in ("in", "out"):
                    continue
                jedge = self._join_edges[i].get(pname)
                bound = node.port_bind.get(pname)
                if jedge is not None:
                    specs = edge_specs[jedge]
                elif bound is not None:
                    specs = (bound if _is_data(bound) else app.getData(bound)).specs()
                elif port.optional:
                    continue
                else:
                    raise PortError(f"{node.name}.ports[{pname!r}]: required input port is "
                                    "unbound")
                port.validate(specs, owner=node.name, port=pname)
                port_specs[pname] = specs
            try:
                out_specs = p.out_specs(in_specs, port_specs)
            except PortError:
                raise
            except Exception as e:
                raise PortError(f"{node.name}: output spec inference failed for input "
                                f"specs {sorted(in_specs)} ({e})") from e
            p.ports.get("out", Port()).validate(out_specs, owner=node.name, port="out")
            edge_specs[self._out_edges[i]] = out_specs
        if self._output_bind is not None:
            bound = self._output_bind
            got = (bound if _is_data(bound) else app.getData(bound)).specs()
            if got != edge_specs["_out"]:
                raise PortError(f"bound output Data specs {got} do not match the inferred "
                                f"pipeline output specs {edge_specs['_out']}")

        # ---- registration and wiring --------------------------------------
        # every input edge gets a private buffer (a spec clone of its
        # example) unless it is handle-bound; run() copies each new input
        # into it and uploads it into the same blob
        handles: Dict[str, DataHandle] = {}
        for edge in self._input_edges:
            if edge == self._input_edges[0] and self._input_handle is not None:
                handles[edge] = self._input_handle
            else:
                handles[edge] = app.addData(Data.from_specs(examples[edge].specs()),
                                            to_device=False)
        for edge in self._out_edges:
            bound = self._output_bind if edge == "_out" else None
            if _is_handle(bound):
                handles[edge] = bound
            else:
                data = bound if _is_data(bound) else Data.from_specs(edge_specs[edge])
                handles[edge] = app.addData(data, to_device=False)
        port_handles: Dict[int, DataHandle] = {}    # id(Data) -> handle
        procs: List[Process] = []
        for i, node in enumerate(self.nodes):
            p = node.process
            if p._app is None:
                p._app = app
            p.in_handles["in"] = handles[self._in_edges[i]]
            for pname, jedge in self._join_edges[i].items():
                p.in_handles[pname] = handles[jedge]
            for pname, bound in node.port_bind.items():
                if _is_data(bound):
                    if id(bound) not in port_handles:
                        port_handles[id(bound)] = app.addData(bound)
                    bound = port_handles[id(bound)]
                p.set_aux_handle(pname, bound)
            p.out_handle = handles[self._out_edges[i]]
            procs.append(p)

        # ---- residency: graph input/output edges keep the host path, other
        # edges and persistent Data (decode state) stay on the device
        residency = {}
        for edge, h in handles.items():
            d = app.getData(h)
            internal = edge not in self._input_edges and edge != self._output_edge
            d.residency = "device" if (internal or d.persistent) else "host"
            residency[edge] = d.residency

        if len(procs) == 1:
            executor = procs[0]
        else:
            executor = ProcessChain(app, procs, mode="fused" if self.fuse else "staged")
        executor.init()
        self._built = _Built(executor=executor, input_edges=tuple(self._input_edges),
                             input_handles={e: handles[e] for e in self._input_edges},
                             output_handle=handles[self._output_edge], residency=residency)
        return self._built

    # ------------------------------------------------------------------ run
    def _item_tuple(self, built: _Built, item: Any, *, what: str = "item") -> Any:
        """Normalise one stream/serve item: the caller supplies one Data per
        graph input edge (a lone Data, an ``{edge: Data}`` mapping, or a
        tuple in :attr:`input_edges` order); the result is a lone Data or a
        tuple in ``built.input_order``, the executor's streamed order."""
        edges = built.input_edges
        n = len(edges)
        if isinstance(item, Data):
            if n != 1:
                raise GraphError(f"{what} is a single Data but this graph joins {n} input "
                                 f"edges {list(edges)}; pass one Data per edge as a "
                                 "{edge name: Data} mapping")
            by_edge = {edges[0]: item}
        elif isinstance(item, Mapping):
            missing = [e for e in edges if e not in item]
            extra = [e for e in item if e not in edges]
            if missing or extra:
                raise GraphError(f"{what} does not cover the graph input edges: missing "
                                 f"{missing}, unknown {extra} (input edges: {list(edges)})")
            by_edge = item
        elif isinstance(item, (tuple, list)):
            if len(item) != n:
                raise GraphError(f"{what} supplies {len(item)} Data for {n} input "
                                 f"edge(s) {list(edges)}")
            by_edge = dict(zip(edges, item))
        else:
            raise GraphError(f"{what} must be a Data or a {{edge name: Data}} mapping, got "
                             f"{type(item).__name__}")
        order = built.input_order
        if len(order) == 1:
            return by_edge[order[0]]
        return tuple(by_edge[e] for e in order)

    def run(self, inputs: Any = None, *, mode: str = "launch", batch: int = 1,
            sharded: bool = False, depth: int = 2, sync: bool = True,
            tail_waste_threshold: float = 0.5, split: str = "equal", lanes: bool = False,
            profile: Optional[ProfileParameters] = None) -> Any:
        """Route the graph through one of three modes:

        ======== ================================ ================================
        mode     inputs                           returns
        ======== ================================ ================================
        launch   one Data, an ``{edge: Data}``    the output Data
                 mapping or a tuple (None when
                 the input is bound)
        stream   a sequence of such items         one output Data per item
        serve    a sequence of such items         one output Data per request, in
                 (requests)                       submit order; each request's
                                                  latency recorded on ``profile``
        ======== ================================ ================================

        ``launch``: each input edge's new Data is copied into that edge's
        own buffer and uploaded in one call into the same device blob, so a
        replayed graph of the executor (:meth:`Process.launch` on the card)
        reads every new input; those uploads are the only host to device
        traffic of a launch, and ``profile`` records them under the
        ``"transfer"`` phase.  A bound input is not uploaded again.

        ``stream`` and ``serve`` take ``batch``, ``depth`` and
        ``tail_waste_threshold`` (:meth:`Process.stream`); a fan-in graph
        batches each edge on its own and joins them row-aligned in one
        launch.  ``sharded``, ``split="proportional"`` and ``lanes`` carve
        each batch over the lanes of the app's mesh (:meth:`Process.stream`),
        every edge by one split vector.  ``sync=True`` copies results back
        to the host."""
        if mode in ("stream", "serve") and isinstance(inputs, (Data, Mapping)):
            raise TypeError(f"mode={mode!r} takes a sequence of items (one Data, mapping or "
                            f"tuple each), got one {type(inputs).__name__}; mode='launch' "
                            "takes one")
        if mode == "stream":
            datasets = list(inputs or ())
            if not datasets:
                return []
            built = self.build(datasets[0])
            items = [self._item_tuple(built, d, what=f"inputs[{i}]")
                     for i, d in enumerate(datasets)]
            return built.executor.stream(items, batch=batch, depth=depth, sync=sync,
                                         sharded=sharded,
                                         tail_waste_threshold=tail_waste_threshold,
                                         split=split, lanes=lanes, profile=profile)
        if mode == "serve":
            requests = list(inputs or ())
            if not requests:
                return []
            server = self.serve(batch=batch, sharded=sharded, depth=depth,
                                tail_waste_threshold=tail_waste_threshold, split=split,
                                lanes=lanes)
            rids = [server.submit(d) for d in requests]
            by_rid = {r.rid: r for r in server.drain()}
            outs = []
            for rid in rids:
                resp = by_rid[rid]
                if profile is not None and profile.enable:
                    profile.record(resp.latency_s)
                if sync:
                    resp.data.sync_to_host()
                outs.append(resp.data)
            return outs
        if mode != "launch":
            raise ValueError(f"unknown mode {mode!r}: expected 'launch' | 'stream' | 'serve'")
        built = self.build(inputs)
        app = self.app
        sources = self._example_inputs(inputs)
        t0 = time.perf_counter()
        uploaded = False
        for edge in built.input_edges:
            h = built.input_handles[edge]
            d_reg = app.getData(h)
            if sources[edge] is not d_reg:
                self._copy_into(d_reg, sources[edge], edge)
                app.host2device(h)
                uploaded = True
            elif d_reg.device_blob is None:
                app.host2device(h)
                uploaded = True
        if uploaded and profile is not None and profile.enable:
            app.wait_transfers()
            profile.record_phase("transfer", time.perf_counter() - t0)
        built.executor.launch(profile)
        out = app.getData(built.output_handle)
        if sync:
            out.sync_to_host()
        return out

    def serve(self, *, batch: int = 8, sharded: bool = False, depth: int = 2,
              tail_waste_threshold: float = 0.5, split: str = "equal", lanes: bool = False,
              flush_timeout: Optional[float] = None):
        """A standing request/response loop over this pipeline (admission
        queue -> dynamic batcher -> batched joined launches); see
        :class:`repro_torch.serve.pipeline.PipelineServer`.  With
        ``flush_timeout`` (seconds) a background thread serves, flushing a
        partial batch once its oldest request waited that long."""
        from repro_torch.serve.pipeline import PipelineServer  # the serve layer builds on this

        return PipelineServer(self, batch=batch, sharded=sharded, depth=depth,
                              tail_waste_threshold=tail_waste_threshold, split=split,
                              lanes=lanes, flush_timeout=flush_timeout)

    @staticmethod
    def _copy_into(dst: Data, src: Data, edge: str = "?") -> None:
        if src.layout is None:
            src.plan()
        if dst.layout is None:
            dst.plan()
        if dst.layout != src.layout:
            raise PortError(f"input Data layout {src.layout} for edge {edge!r} does not "
                            f"match the layout the pipeline was built for ({dst.layout})")
        for a_dst, a_src in zip(dst, src):
            if a_src.host is None:
                raise PortError(f"input array {a_src.name!r} has no host values")
            a_dst.set_host(a_src.host)

    def __repr__(self):
        return f"Pipeline[{' | '.join(n.name for n in self.nodes) or '<empty>'}]"
