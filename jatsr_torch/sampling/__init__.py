from .flow import FlowSampler, flow_interpolate, u_shaped_timesteps

__all__ = ["FlowSampler", "flow_interpolate", "u_shaped_timesteps"]
