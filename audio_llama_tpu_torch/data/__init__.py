"""Host-side data: audio file IO and tokenizers."""
