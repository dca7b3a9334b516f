"""Client drivers: the driver contracts (``definitions``), the in-process
local driver (``local_driver``) and the reconnecting read-only observer
client (``resilient``)."""
