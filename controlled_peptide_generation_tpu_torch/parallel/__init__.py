"""Data parallelism of the port: process groups (``dist``), the DP step's
collectives (``collectives``), ZeRO-1 (``zero``) and the device list of
the CLaSS rounds (``rounds``)."""
