from hgaprec_jax.data.ratings import RatingsStore, CountMap
from hgaprec_jax.data.device import DeviceData, build_device_data

__all__ = ["RatingsStore", "CountMap", "DeviceData", "build_device_data"]
