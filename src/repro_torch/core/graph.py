"""Declarative operator graphs: :class:`Node` and :class:`Pipeline`.

A :class:`~repro_torch.core.process.Process` is wired with
:meth:`~repro_torch.core.process.Process.bind`, which maps its ports to
named edges, Data or registered handles, and returns a :class:`Node`::

    step = DecodeStep(app, model, wcodec, ccodec, max_len=2048).bind(
        infile=state_h, outfile=state_h, weights=weights_h)
    pipe = Pipeline(app) | step
    out = pipe.run(None, sync=False)

This is the part of ``repro.core.graph`` that the LM serving path uses:
linear ``|`` composition (a node without an ``in`` binding consumes the
previous node's output edge), build-time validation, and the launch mode.
Secondary input ports (weights, a spliced row) are bound to concrete Data
or handles and read live at each launch.  ``from_graph`` fan-in DAGs with
joins on named edges, and the stream and serve modes, come with later
slices of the port.

Validation happens when the graph is composed or built, never at launch:

* an undeclared port, or concrete Data that violates a
  :class:`~repro_torch.core.process.Port`, raises ``PortError`` from
  ``bind()``;
* consuming an edge no node produces, producing one edge twice, or a
  concrete input/output on an inner node raises :class:`GraphError`;
* shape/dtype mismatches between nodes raise ``PortError`` from
  ``build()``: each node's output specs come from
  :meth:`~repro_torch.core.process.Process.out_specs` (``apply`` on
  ``meta`` tensors unless the process states them), so nothing is
  allocated or run to reject a graph.

``build()`` then allocates every edge Data from the inferred specs, wires
the processes over arena handles, and runs their ``init()``.  A
``persistent`` Data (a decode state bound as both the input and the output
of a step) is planned device-resident: processes write it in place and it
is never synced to the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

from .app import CLapp, DataHandle
from .data import Data
from .process import Port, PortError, Process, ProcessChain, ProfileParameters


class GraphError(ValueError):
    """The operator graph is mis-wired.  Raised while the graph is composed
    or built, never at launch."""


def _is_edge(b: Any) -> bool:
    return isinstance(b, str)


def _is_data(b: Any) -> bool:
    return isinstance(b, Data)


def _is_handle(b: Any) -> bool:
    return isinstance(b, int) and not isinstance(b, bool)


class Node:
    """One bound operator: a Process plus its port bindings (made by
    :meth:`Process.bind`, which validates them at once)."""

    def __init__(self, process: Process, in_bind: Any = None, out_bind: Any = None,
                 port_bind: Optional[Dict[str, Any]] = None):
        self.process = process
        self.in_bind = in_bind
        self.out_bind = out_bind
        self.port_bind: Dict[str, Any] = dict(port_bind or {})
        self.name = type(process).__name__
        self._validate()

    def _validate(self) -> None:
        ports = self.process.ports
        inputs = set(ports) - {"in", "out"}
        unknown = set(self.port_bind) - inputs
        if unknown:
            raise PortError(f"{self.name}.bind: no input port(s) named {sorted(unknown)}; "
                            f"declared input ports: {sorted(inputs)}")
        for slot, bind in (("in", self.in_bind), ("out", self.out_bind)):
            if not (bind is None or _is_edge(bind) or _is_data(bind) or _is_handle(bind)):
                raise PortError(f"{self.name}.bind: {slot!r} must be an edge name, a Data "
                                f"or a DataHandle, got {type(bind).__name__}")
        for pname, bind in self.port_bind.items():
            if _is_edge(bind):
                raise GraphError(
                    f"{self.name}.bind: port {pname!r} bound to edge {bind!r}; joining a "
                    "named edge into a secondary port is a fan-in graph, which the port "
                    "does not build yet: bind a Data or a registered handle")
            if not (_is_data(bind) or _is_handle(bind)):
                raise PortError(f"{self.name}.bind: port {pname!r} must be a Data or a "
                                f"DataHandle, got {type(bind).__name__}")
            if _is_data(bind):
                ports[pname].validate(bind.specs(), owner=self.name, port=pname)
        if _is_data(self.in_bind):
            ports["in"].validate(self.in_bind.specs(), owner=self.name, port="in")

    def __repr__(self):
        return (f"Node({self.name}, in={self.in_bind!r}, out={self.out_bind!r}, "
                f"ports={sorted(self.port_bind)})")


@dataclasses.dataclass
class _Built:
    """State cached by :meth:`Pipeline.build`."""

    executor: Process                   # the single node's process, or a staged chain
    input_handle: DataHandle
    output_handle: DataHandle
    #: edge name -> 'host' (graph input/output edges) or 'device'
    #: (internal edges and persistent Data)
    residency: Dict[str, str]


class Pipeline:
    """A validated chain of bound operator nodes; ``Pipeline(app) | node``."""

    def __init__(self, app: CLapp, nodes: Sequence[Node | Process] = ()):
        self.app = app
        self.nodes: List[Node] = [self._as_node(n) for n in nodes]
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
        return Pipeline(self.app, self.nodes + [self._as_node(other)])

    # ------------------------------------------------------------- planning
    def _plan_edges(self) -> None:
        """Name every node's input and output edge; reject mis-wiring."""
        self._in_edges: List[str] = []
        self._out_edges: List[str] = []
        self._input_data: Optional[Data] = None
        self._input_handle: Optional[DataHandle] = None
        self._output_bind: Any = None
        produced: Dict[str, int] = {}
        last = len(self.nodes) - 1
        for i, node in enumerate(self.nodes):
            b = node.in_bind
            if i == 0:
                if _is_data(b):
                    self._input_data = b
                elif _is_handle(b):
                    self._input_handle = b
                edge = b if _is_edge(b) else "_in"
                produced[edge] = -1
            elif b is None:
                edge = self._out_edges[-1]
            elif _is_edge(b):
                if b not in produced:
                    raise GraphError(f"node {i} ({node.name}) consumes edge {b!r} which no "
                                     f"upstream node produces (known edges: {sorted(produced)})")
                edge = b
            else:
                raise GraphError(f"node {i} ({node.name}): only the first node may bind a "
                                 "concrete input Data/handle")
            out = node.out_bind
            if _is_data(out) or _is_handle(out):
                if i != last:
                    raise GraphError(f"node {i} ({node.name}): only the last node may bind "
                                     "a concrete output Data/handle")
                self._output_bind = out
                out_edge = "_out"
            else:
                out_edge = out if _is_edge(out) else f"_e{i}"
            if out_edge in produced:
                raise GraphError(f"edge {out_edge!r} is produced twice (node {i}, "
                                 f"{node.name})")
            produced[out_edge] = i
            self._in_edges.append(edge)
            self._out_edges.append(out_edge)

    # ---------------------------------------------------------------- build
    @property
    def residency_plan(self) -> Dict[str, str]:
        if self._built is None:
            raise GraphError("pipeline not built yet")
        return dict(self._built.residency)

    def _example_input(self, inputs: Any) -> Data:
        if inputs is not None:
            if not _is_data(inputs):
                raise TypeError(f"Pipeline.run takes one Data in launch mode, got "
                                f"{type(inputs).__name__}")
            return inputs
        if self._input_data is not None:
            return self._input_data
        if self._input_handle is not None:
            return self.app.getData(self._input_handle)
        raise GraphError("no Data for the input edge: bind it with infile= or pass one")

    def build(self, inputs: Any = None) -> _Built:
        """Validate every port against the inferred specs, allocate the edge
        Data, wire the processes and run their ``init()`` (once; cached)."""
        if self._built is not None:
            return self._built
        if not self.nodes:
            raise GraphError("cannot build an empty pipeline")
        app = self.app
        example = self._example_input(inputs)

        # ---- validation: specs flow edge to edge, nothing is allocated ----
        edge_specs = {self._in_edges[0]: example.specs()}
        for i, node in enumerate(self.nodes):
            p = node.process
            in_specs = edge_specs[self._in_edges[i]]
            p.ports.get("in", Port()).validate(in_specs, owner=node.name, port="in")
            port_specs = {}
            for pname, port in p.ports.items():
                if pname in ("in", "out"):
                    continue
                bound = node.port_bind.get(pname)
                if bound is None:
                    if not port.optional:
                        raise PortError(f"{node.name}.ports[{pname!r}]: required input "
                                        "port is unbound")
                    continue
                data = bound if _is_data(bound) else app.getData(bound)
                port.validate(data.specs(), owner=node.name, port=pname)
                port_specs[pname] = data.specs()
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
        # the input edge gets a private buffer (a spec clone of the example)
        # unless it is handle-bound; run() copies each new input into it
        in_edge = self._in_edges[0]
        handles: Dict[str, DataHandle] = {}
        if self._input_handle is not None:
            handles[in_edge] = self._input_handle
        else:
            handles[in_edge] = app.addData(Data.from_specs(example.specs()), to_device=False)
        for i, edge in enumerate(self._out_edges):
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
            for pname, bound in node.port_bind.items():
                if _is_data(bound):
                    if id(bound) not in port_handles:
                        port_handles[id(bound)] = app.addData(bound)
                    bound = port_handles[id(bound)]
                p.in_handles[pname] = bound
            p.out_handle = handles[self._out_edges[i]]
            procs.append(p)

        # ---- residency: graph input/output edges keep the host path, other
        # edges and persistent Data (decode state) stay on the device
        out_edge = self._out_edges[-1]
        residency = {}
        for edge, h in handles.items():
            d = app.getData(h)
            internal = edge not in (in_edge, out_edge)
            d.residency = "device" if (internal or d.persistent) else "host"
            residency[edge] = d.residency

        executor = procs[0] if len(procs) == 1 else ProcessChain(app, procs, mode="staged")
        executor.init()
        self._built = _Built(executor=executor, input_handle=handles[in_edge],
                             output_handle=handles[out_edge], residency=residency)
        return self._built

    # ------------------------------------------------------------------ run
    def run(self, inputs: Any = None, *, mode: str = "launch", sync: bool = True,
            profile: Optional[ProfileParameters] = None) -> Data:
        """Launch the graph once on ``inputs`` (one Data, or None when the
        input is bound) and return the output Data; ``sync=True`` copies it
        back to the host.  A new input is copied into the pipeline's input
        buffer and uploaded in one call into the same device blob, so a
        replayed graph of the executor (:meth:`Process.launch` on the card)
        reads it; that upload is the only host to device traffic of a
        launch, and ``profile`` records it under the ``"transfer"`` phase.
        With the input bound (``run(None)``) nothing is uploaded."""
        if mode != "launch":
            raise NotImplementedError(
                f"mode {mode!r}: the port has the launch mode; stream and serve come "
                "with the stream slice (ROADMAP)")
        built = self.build(inputs)
        app = self.app
        src = self._example_input(inputs)
        d_reg = app.getData(built.input_handle)
        t0 = time.perf_counter()
        uploaded = False
        if src is not d_reg:
            self._copy_into(d_reg, src)
            app.host2device(built.input_handle)
            uploaded = True
        elif d_reg.device_blob is None:
            app.host2device(built.input_handle)
            uploaded = True
        if uploaded and profile is not None and profile.enable:
            app.wait_transfers()
            profile.record_phase("transfer", time.perf_counter() - t0)
        built.executor.launch(profile)
        out = app.getData(built.output_handle)
        if sync:
            out.sync_to_host()
        return out

    @staticmethod
    def _copy_into(dst: Data, src: Data) -> None:
        if src.layout is None:
            src.plan()
        if dst.layout is None:
            dst.plan()
        if dst.layout != src.layout:
            raise PortError(f"input Data layout {src.layout} does not match the layout the "
                            f"pipeline was built for ({dst.layout})")
        for a_dst, a_src in zip(dst, src):
            if a_src.host is None:
                raise PortError(f"input array {a_src.name!r} has no host values")
            a_dst.set_host(a_src.host)

    def __repr__(self):
        return f"Pipeline[{' | '.join(n.name for n in self.nodes) or '<empty>'}]"
