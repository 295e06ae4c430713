"""Model configs served by the PyTorch port."""


def model_configs():
    """Name -> config factory, every name the TPU package registers: the
    Llama-3 family, Mixtral-class MoE, Gemma and StarCoder2."""
    from generativeaiexamples_tpu_torch.models import gemma, llama, starcoder2

    return {
        "llama3-8b": llama.LlamaConfig.llama3_8b,
        "llama3-70b": llama.LlamaConfig.llama3_70b,
        "mixtral-8x7b": llama.LlamaConfig.mixtral_8x7b,
        "tiny-moe": llama.LlamaConfig.tiny_moe,
        "gemma-2b": gemma.gemma_2b,
        "gemma-7b": gemma.gemma_7b,
        "codegemma-7b": gemma.codegemma_7b,
        "starcoder2-3b": starcoder2.starcoder2_3b,
        "starcoder2-7b": starcoder2.starcoder2_7b,
        "tiny": llama.LlamaConfig.tiny,
        "tiny-gemma": gemma.tiny,
        "tiny-starcoder2": starcoder2.tiny,
    }


def model_config(name: str):
    """The config called ``name``; raises for a name no family has."""
    configs = model_configs()
    if name not in configs:
        raise NotImplementedError(
            f"model family {name!r} is not a registered family; known: "
            f"{sorted(configs)}")
    return configs[name]()
