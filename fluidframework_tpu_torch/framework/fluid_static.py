"""The simple public API: container schema + FluidContainer + client.

Reference counterpart: ``fluid-framework`` / ``@fluidframework/fluid-static``
(``ContainerSchema``, ``IFluidContainer.initialObjects``,
``container.create``) and the service clients built on it
(``@fluidframework/tinylicious-client``, ``azure-client``) — SURVEY.md §1
L5, §2.12 (mount empty). This is the three-line on-ramp:

    client = LocalClient()
    container, doc_id = client.create_container(
        {"initialObjects": {"todo": "map", "text": "sharedString"}})
    container.initial_objects["todo"].set("k", "v")

Initial objects are channels of the default datastore, created by the
creating client and realized from attach ops / summaries everywhere else.
Dynamic objects (``container.create``) get generated ids; store their
``handle`` in an initial object to keep them GC-reachable.

Counterpart of ``fluidframework_tpu/framework/fluid_static.py``;
``NetworkClient`` waits for the JSON socket door. Behind
``LocalClient(service=ServingLocalService(...))`` every string channel is
also merged on the card.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, Optional, Tuple

from ..drivers.definitions import DocumentServiceFactory
from ..drivers.local_driver import LocalDocumentServiceFactory
from ..loader.container import Container, Loader
from ..models.shared_object import SharedObject
from ..runtime.container_runtime import (
    ContainerRuntime, ContainerRuntimeOptions,
)
from ..runtime.gc import fluid_handle
from ..runtime.summarizer import SummaryConfig, SummaryManager

DEFAULT_DS = "default"
DYNAMIC_DS = "dynamic"


class FluidContainer:
    """Reference: IFluidContainer — the app-facing wrapper."""

    def __init__(self, container: Container, schema: dict):
        self._container = container
        self._schema = schema
        self._initial: Dict[str, SharedObject] = {}

    # ----------------------------------------------------------------- state

    @property
    def container(self) -> Container:
        return self._container

    @property
    def connected(self) -> bool:
        return self._container.connected

    @property
    def initial_objects(self) -> Dict[str, SharedObject]:
        if not self._initial:
            ds = self._container.runtime.get_data_store(DEFAULT_DS)
            for name in self._schema.get("initialObjects", {}):
                self._initial[name] = ds.get_channel(name)
        return dict(self._initial)

    # -------------------------------------------------------------- dynamics

    def create(self, type_name: str) -> SharedObject:
        """Create a dynamic object (reference: container.create). Returns
        the live channel; persist its handle somewhere reachable or GC will
        sweep its datastore."""
        rt = self._container.runtime
        if not rt.has_data_store(DYNAMIC_DS):
            rt.create_data_store(DYNAMIC_DS, root=False)
        channel_id = f"{type_name}-{uuid.uuid4().hex[:8]}"
        return rt.get_data_store(DYNAMIC_DS).create_channel(
            channel_id, type_name)

    @staticmethod
    def handle_of(obj: SharedObject, ds_id: str = DYNAMIC_DS) -> dict:
        """Serialized handle for storing references to dynamic objects."""
        return fluid_handle(ds_id, obj.id)

    def resolve_handle(self, handle: dict) -> SharedObject:
        ds_id, channel_id = handle["url"].lstrip("/").split("/", 1)
        return self._container.runtime.get_data_store(ds_id) \
            .get_channel(channel_id)

    # ------------------------------------------------------------- lifecycle

    def on(self, event: str, fn) -> None:
        self._container.on(event, fn)

    def submit_signal(self, contents: Any) -> None:
        self._container.submit_signal(contents)

    def flush(self) -> int:
        return self._container.runtime.flush()

    def disconnect(self, reason: str = "") -> None:
        self._container.disconnect(reason)

    def connect(self) -> None:
        self._container.connect()

    def pump(self, timeout: float = 0.0) -> int:
        """Dispatch queued inbound frames on this thread (network driver in
        auto_pump=False mode; no-op for synchronous drivers)."""
        conn = self._container.delta_manager.connection
        if conn is not None and hasattr(conn, "pump"):
            return conn.pump(timeout)
        return 0

    def pump_until(self, predicate, timeout: float = 10.0) -> None:
        """Pump until ``predicate()`` is true (raises TimeoutError)."""
        import time as _time
        deadline = _time.monotonic() + timeout
        while not predicate():
            if _time.monotonic() > deadline:
                raise TimeoutError("pump_until condition not reached")
            self.pump(timeout=0.05)

    def dispose(self) -> None:
        self._container.close()


class ServiceClient:
    """Base service client (reference: TinyliciousClient / AzureClient
    shape): ``create_container`` / ``get_container`` against one backend's
    DocumentServiceFactory."""

    def __init__(self, factory: DocumentServiceFactory,
                 runtime_options: Optional[ContainerRuntimeOptions] = None,
                 summary_config: Optional[SummaryConfig] = None):
        self.factory = factory
        self.runtime_options = runtime_options
        self.summary_config = summary_config
        self._loader = Loader(
            factory, ContainerRuntime.factory(options=runtime_options))

    def create_container(self, schema: dict,
                         doc_id: Optional[str] = None
                         ) -> Tuple[FluidContainer, str]:
        doc_id = doc_id or uuid.uuid4().hex[:12]
        container = self._loader.resolve(doc_id)
        ds = container.runtime.create_data_store(DEFAULT_DS)
        for name, type_name in schema.get("initialObjects", {}).items():
            ds.create_channel(name, type_name)
        container.runtime.flush()
        self._attach_summarizer(container)
        return FluidContainer(container, schema), doc_id

    def get_container(self, doc_id: str, schema: dict) -> FluidContainer:
        container = self._loader.resolve(doc_id)
        self._attach_summarizer(container)
        return FluidContainer(container, schema)

    def _attach_summarizer(self, container: Container) -> None:
        container._summary_manager = SummaryManager(  # keep it alive
            container, config=self.summary_config)


class LocalClient(ServiceClient):
    """Reference: TinyliciousClient — the zero-config local-service client."""

    def __init__(self, service=None, **kwargs):
        factory = LocalDocumentServiceFactory(service)
        super().__init__(factory, **kwargs)
        self.service = factory.service

