"""CLIP ViT model, tokenizer, checkpoint reading and encoder loading."""
