from .device import (CPUPlace, CUDAPlace, Place, device_count, get_device,
                     resolve_device, set_device)

__all__ = ["resolve_device", "Place", "CPUPlace", "CUDAPlace", "set_device",
           "get_device", "device_count"]
