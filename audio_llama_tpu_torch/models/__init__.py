"""Model code of the port: Whisper encoder, projector, LoRA, Llama, AudioLLM."""
