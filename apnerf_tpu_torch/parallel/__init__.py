"""The multi-device layer of the port: the (ens, data) mesh on ``torch.distributed``."""
