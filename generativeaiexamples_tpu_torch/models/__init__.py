"""Model configs served by the PyTorch port."""


def model_configs():
    """Name -> config factory (the names the TPU package uses). The
    Llama-3 and Gemma families are ported; StarCoder2 and the MoE configs
    are ROADMAP A.12."""
    from generativeaiexamples_tpu_torch.models import gemma, llama

    return {
        "llama3-8b": llama.LlamaConfig.llama3_8b,
        "llama3-70b": llama.LlamaConfig.llama3_70b,
        "gemma-2b": gemma.gemma_2b,
        "gemma-7b": gemma.gemma_7b,
        "codegemma-7b": gemma.codegemma_7b,
        "tiny": llama.LlamaConfig.tiny,
        "tiny-gemma": gemma.tiny,
    }


def model_config(name: str):
    """The config called ``name``; raises for families not ported yet."""
    configs = model_configs()
    if name not in configs:
        raise NotImplementedError(
            f"model family {name!r} is not ported to PyTorch yet (ROADMAP "
            f"A.12); ported: {sorted(configs)}")
    return configs[name]()
