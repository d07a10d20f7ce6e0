"""The Llama text path: host tokenization, the decoder and the text attention."""
