from repro_torch.data.toy_ocssvm import make_toy

__all__ = ["make_toy"]
