"""The system under test, built from a configuration file and the
benchmark's own data: the only place the harness constructs the port's
objects (``repro_torch``, never the JAX package)."""
from __future__ import annotations

__all__ = ["network_and_events", "model_kwargs", "build_model", "build_server"]


def network_and_events(ds):
    from repro_torch.core.events import Events
    from repro_torch.core.network import RoadNetwork

    net = RoadNetwork(n_vertices=ds.n_vertices, edge_src=ds.edge_src, edge_dst=ds.edge_dst,
                      edge_len=ds.edge_len)
    return net, Events(edge_id=ds.ev_edge, pos=ds.ev_pos, time=ds.ev_time)


def model_kwargs(cfg, b_t):
    """``TNKDE`` keyword arguments that a configuration file states."""
    return dict(g=float(cfg["g"]), b_s=float(cfg["b_s"]), b_t=float(b_t),
                spatial_kernel=cfg["spatial_kernel"], temporal_kernel=cfg["temporal_kernel"],
                solution=cfg["solution"], engine=cfg["engine"], executor=cfg["executor"],
                lixel_sharing=bool(cfg["lixel_sharing"]))


def build_model(cfg, ds, b_t, device):
    from repro_torch.core import TNKDE

    net, ev = network_and_events(ds)
    return TNKDE(net, ev, table_codec=cfg["table_codec"], device=device,
                 **model_kwargs(cfg, b_t))


def build_server(cfg, ds, b_t, device, profile: str):
    """A ``TNKDEServer`` with one profile of the configuration. The server's
    profiles take no table codec; a configuration that states another codec
    than f64 has its profile's model rebuilt with it (controls only)."""
    from repro_torch.serve import ProfileConfig, TNKDEServer

    net, ev = network_and_events(ds)
    kw = model_kwargs(cfg, b_t)
    server = TNKDEServer(net, ev, {profile: ProfileConfig(**kw)}, device=device,
                         **cfg["serve"])
    if cfg["table_codec"] not in ("auto", "f64"):
        server.models[profile] = build_model(cfg, ds, b_t, device)
    return server
