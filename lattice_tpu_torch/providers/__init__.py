"""Providers: the hash provider, the UniXcoder encoder, the HTTP
providers, their base classes and the factory that picks one."""
