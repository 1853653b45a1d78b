"""Plotting helpers (counterpart of ``prysm_tpu/plotting.py``).

Host-side; matplotlib is imported when a function is called, never when
the module is imported.
"""


def share_fig_ax(fig=None, ax=None, numax=1, sharex=False, sharey=False):
    """Reuse or create a (fig, ax) pair."""
    import matplotlib.pyplot as plt
    if fig is None and ax is None:
        fig, ax = plt.subplots(ncols=numax, sharex=sharex, sharey=sharey)
    elif ax is None:
        ax = fig.gca()
    return fig, ax


def add_psd_model(psd_dict, fig=None, ax=None, invert_x=False, **kwargs):
    """Plot a PSD model (abc or ab form) on an axis."""
    import numpy as np
    from .interferogram import abc_psd, ab_psd
    fig, ax = share_fig_ax(fig, ax)
    xlims = ax.get_xlim()
    nu = np.logspace(np.log10(max(xlims[0], 1e-9)), np.log10(max(xlims[1], 1e-6)), 100)
    if 'c' in psd_dict:
        model = abc_psd(nu, psd_dict['a'], psd_dict['b'], psd_dict['c'])
    else:
        model = ab_psd(nu, psd_dict['a'], psd_dict['b'])
    u = 1 / nu if invert_x else nu
    ax.plot(u, np.asarray(model), **kwargs)
    return fig, ax
