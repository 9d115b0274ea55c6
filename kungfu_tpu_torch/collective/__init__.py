"""The host plane's collective engine. Port of `kungfu_tpu/collective/`,
so far its strategy lists (`strategies`); the walks, the session and the
codec layer come with the engine's slice."""
