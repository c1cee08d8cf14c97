"""BN folding, the polyphase frontend and the fused upsample+argmax kernel."""
