"""Architecture registry: --arch <id> resolves through ARCHS."""

from importlib import import_module

_MODULES = {
    "xlstm-1.3b": "xlstm_1_3b",
    "internvl2-76b": "internvl2_76b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "starcoder2-7b": "starcoder2_7b",
    "smollm-360m": "smollm_360m",
    "minitron-4b": "minitron_4b",
    "zamba2-1.2b": "zamba2_1_2b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCHS = tuple(_MODULES)


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return import_module(f"repro_torch.configs.{_MODULES[name]}").config()
