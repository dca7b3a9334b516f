"""Framework / app-model layer: the container schema, ``FluidContainer``
and the service clients.

Counterpart of ``fluidframework_tpu/framework/``, of which this package
has ``fluid_static.py`` without ``NetworkClient``.
"""

from .fluid_static import FluidContainer, LocalClient, ServiceClient

__all__ = ["FluidContainer", "LocalClient", "ServiceClient"]
