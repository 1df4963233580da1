"""Parallelism of the port: process groups and the (data, pipe, model)
mesh (``dist``), the collectives of a step (``collectives``), ZeRO-1
(``zero``), tensor and pipeline parallelism of the transformer family
(``tp``, ``pp``) and the device list of the CLaSS rounds (``rounds``)."""
