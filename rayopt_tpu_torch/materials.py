"""Materials and chromatic dispersion.

Parity with reference material.py: the Fraunhofer line table, the
Material/ModelMaterial/AbbeMaterial/CoefficientsMaterial hierarchy with
19 dispersion formulas (reference material.py:240-322), a Thermal dn/dT
model (reference material.py:54), and string parsing via Material.make
(reference material.py:88).

The formula family is written as pure NumPy functions vectorized over
wavelength (``n_<typ>(w_um, coeffs)``).

A built-in catalog of common Schott glasses ships in GLASSES (public
dispersion constants from the Schott/refractiveindex.info catalogs) so
the golden-system tests run without an external database.  Catalog
I/O (the sqlite glass library) is not part of this package yet: a
name that is neither basic nor in GLASSES raises KeyError.
"""

import functools

import numpy as np

from .utils.registry import NameMixin

__all__ = [
    "Material", "ModelMaterial", "AbbeMaterial", "CoefficientsMaterial",
    "Thermal", "vacuum", "mirror", "air", "basic", "fraunhofer",
    "lambda_F", "lambda_d", "lambda_C", "GLASSES", "DISPERSION_FORMULAS",
]


fraunhofer = dict(     # wavelength in m, https://en.wikipedia.org/wiki/Abbe_number
    i=365.01e-9,       # Hg UV
    h=404.66e-9,       # Hg violet
    g=435.84e-9,       # Hg blue
    Fp=479.99e-9,      # Cd blue
    F=486.13e-9,       # H  blue
    e=546.07e-9,       # Hg green
    d=587.56e-9,       # He yellow
    D=589.30e-9,       # Na yellow
    Cp=643.85e-9,      # Cd red
    C=656.27e-9,       # H  red
    r=706.52e-9,       # He red
    Ap=768.20e-9,      # K  IR
    s=852.11e-9,       # Cs IR
    t=1013.98e-9,      # Hg IR
)

lambda_F = fraunhofer["F"]
lambda_d = fraunhofer["d"]
lambda_C = fraunhofer["C"]


# -- dispersion formula family -------------------------------------------
# All take wavelength w in micrometers (scalar or array) and a 1-D
# coefficient vector c, and return the refractive index with the same
# shape as w.  Semantics follow reference material.py:240-322; sums over
# coefficient pairs are written with an explicit trailing axis so w may
# be batched.

def _pairs(c, skip=0):
    c = np.asarray(c, dtype=float)
    n = (c.shape[0] - skip)//2*2
    return c[skip:skip + n].reshape(-1, 2).T


def n_schott(w, c):
    w2 = w**2
    n = c[0] + c[1]*w2
    for i, ci in enumerate(c[2:]):
        n = n + ci*w2**(-(i + 1))
    return np.sqrt(n)


def n_sellmeier(w, c):
    c0, c1 = _pairs(c)
    w2 = np.asanyarray(w)[..., None]**2
    return np.sqrt(1. + (c0*w2/(w2 - c1**2)).sum(-1))


def n_sellmeier_squared(w, c):
    c0, c1 = _pairs(c)
    w2 = np.asanyarray(w)[..., None]**2
    return np.sqrt(1. + (c0*w2/(w2 - c1)).sum(-1))


def n_sellmeier_squared_transposed(w, c):
    c = np.asarray(c, dtype=float)
    c0, c1 = c.reshape(2, -1)
    w2 = np.asanyarray(w)[..., None]**2
    return np.sqrt(1. + (c0*w2/(w2 - c1)).sum(-1))


def n_conrady(w, c):
    return c[0] + c[1]/w + c[2]/w**3.5


def n_herzberger(w, c):
    el = 1./(w**2 - .028)
    return (c[0] + c[1]*el + c[2]*el**2 +
            c[3]*w**2 + c[4]*w**4 + c[5]*w**6)


def n_sellmeier_offset(w, c):
    c0, c1 = _pairs(c, skip=1)
    w2 = np.asanyarray(w)[..., None]**2
    return np.sqrt(1. + c[0] + (c0*w2/(w2 - c1**2)).sum(-1))


def n_sellmeier_squared_offset(w, c):
    c0, c1 = _pairs(c, skip=1)
    w2 = np.asanyarray(w)[..., None]**2
    return np.sqrt(1. + c[0] + (c0*w2/(w2 - c1)).sum(-1))


def n_handbook_of_optics1(w, c):
    return np.sqrt(c[0] + (c[1]/(w**2 - c[2])) - (c[3]*w**2))


def n_handbook_of_optics2(w, c):
    return np.sqrt(c[0] + (c[1]*w**2/(w**2 - c[2])) - (c[3]*w**2))


def n_extended2(w, c):
    w2 = w**2
    n = c[0] + c[1]*w2 + c[6]*w2**2 + c[7]*w2**3
    for i, ci in enumerate(c[2:6]):
        n = n + ci*w2**(-(i + 1))
    return np.sqrt(n)


def n_hikari(w, c):
    w2 = w**2
    n = c[0] + c[1]*w2 + c[2]*w2**2
    for i, ci in enumerate(c[3:]):
        n = n + ci*w2**(-(i + 1))
    return np.sqrt(n)


def n_gas(w, c):
    # interleaved (amplitude, center) pairs as in rii formula 6:
    # n - 1 = sum ci/(ci+1 - w^-2)
    c0, c1 = _pairs(c)
    iw2 = np.asanyarray(w)[..., None]**-2.
    return 1. + (c0/(c1 - iw2)).sum(-1)


def n_gas_offset(w, c):
    return c[0] + n_gas(w, c[1:])


def n_refractiveindex_info(w, c):
    c0, c1 = _pairs(c, skip=9)
    w = np.asanyarray(w)
    w2 = w**2
    return np.sqrt(c[0] + c[1]*w**c[2]/(w2 - c[3]**c[4]) +
                   c[5]*w**c[6]/(w2 - c[7]**c[8]) +
                   (c0*w[..., None]**c1).sum(-1))


def n_retro(w, c):
    w2 = w**2
    a = c[0] + c[1]*w2/(w2 - c[2]) + c[3]*w2
    return np.sqrt(2 + 1/(a - 1))


def n_cauchy(w, c):
    c0, c1 = _pairs(c, skip=1)
    w = np.asanyarray(w)
    return c[0] + (c0*w[..., None]**c1).sum(-1)


def n_polynomial(w, c):
    return np.sqrt(n_cauchy(w, c))


def n_exotic(w, c):
    return np.sqrt(c[0] + c[1]/(w**2 - c[2]) +
                   c[3]*(w - c[4])/((w - c[4])**2 + c[5]))


DISPERSION_FORMULAS = {
    name[2:]: fn for name, fn in list(globals().items())
    if name.startswith("n_") and callable(fn)
}


class Thermal:
    """Schott dn/dT thermal model (reference material.py:54).

    d = (D0, D1, D2), e = (E0, E1); lref is the E-term resonance
    wavelength lambda_TK in micrometers (as given in AGF TD records).
    """

    def __init__(self, d, e, tref=20., lref=0.):
        self.d = d
        self.e = e
        self.tref = tref
        self.lref = lref

    def dn_thermal(self, t, n, wavelength=lambda_d):
        dt = t - self.tref
        w = wavelength/1e-6
        dn = (n**2 - 1)/(2*n)*(
            self.d[0]*dt + self.d[1]*dt**2 + self.d[2]*dt**3 +
            (self.e[0]*dt + self.e[1]*dt**2)/(w**2 - self.lref**2))
        return dn

    def dict(self):
        return {"d": self.d, "e": self.e,
                "tref": self.tref, "lref": self.lref}


class Material(NameMixin):
    """Base optical material (reference material.py:79)."""

    _type = "basic"
    _default_type = "basic"

    def __init__(self, name="-", solid=True, mirror=False, catalog=None,
                 thermal=None):
        self.name = name
        self.solid = solid
        self.mirror = mirror
        self.catalog = catalog
        if isinstance(thermal, dict):
            thermal = Thermal(**thermal)
        self.thermal = thermal

    @classmethod
    def make(cls, name):
        """Parse float / (nd, vd) tuple / 'name' / 'catalog/name' strings
        into a Material (reference material.py:88)."""
        if name is None:
            return None
        if isinstance(name, Material):
            return name
        if isinstance(name, dict):
            return super(Material, cls).make(name)
        if isinstance(name, (int, float)) and not isinstance(name, bool):
            return ModelMaterial(n=float(name))
        if isinstance(name, tuple):
            return AbbeMaterial(n=name[0], v=name[1])
        try:
            return AbbeMaterial.from_string(name)
        except ValueError:
            pass
        parts = str(name).lower().split("/")
        name = parts.pop()
        source, catalog = None, None
        if parts:
            catalog = parts.pop()
        if parts:
            source = parts.pop()
        if catalog in (None, "basic") and name in basic:
            return basic[name]
        got = _glass_lookup(name, catalog)
        if got is not None:
            return got
        raise KeyError(
            "material %r (catalog %r) is not in the built-in GLASSES "
            "table; catalog I/O is not ported to rayopt_tpu_torch yet"
            % (name, catalog))

    def __str__(self):
        if self.catalog is not None:
            return f"{self.catalog}/{self.name}"
        return self.name

    def dict(self):
        dat = NameMixin.dict(self)
        if self.name:
            dat["name"] = self.name
        if not self.solid:
            dat["solid"] = self.solid
        if self.mirror:
            dat["mirror"] = self.mirror
        if self.catalog:
            dat["catalog"] = self.catalog
        if self.thermal:
            dat["thermal"] = self.thermal.dict()
        return dat

    @functools.lru_cache(maxsize=1024)
    def refractive_index(self, wavelength):
        return 1.

    def dispersion(self, short, mid, long):
        dn = self.delta_n(short, long)
        if dn:
            return (self.refractive_index(mid) - 1)/dn
        return np.inf

    def delta_n(self, short, long):
        return (self.refractive_index(short) -
                self.refractive_index(long))

    @property
    def nd(self):
        return self.refractive_index(lambda_d)

    @property
    def vd(self):
        return self.dispersion(lambda_F, lambda_d, lambda_C)


class ModelMaterial(Material):
    """Constant-index material (reference material.py:161)."""

    _type = "model"

    def __init__(self, n=1., **kwargs):
        super().__init__(**kwargs)
        self.n = n

    def refractive_index(self, wavelength):
        return self.n

    def dict(self):
        dat = super().dict()
        dat["n"] = self.n
        return dat


class AbbeMaterial(Material):
    """Linear-in-wavelength index model from (nd, vd)
    (reference material.py:176)."""

    _type = "abbe"

    def __init__(self, n=1., v=np.inf, lambda_ref=lambda_d,
                 lambda_long=lambda_C, lambda_short=lambda_F, **kwargs):
        super().__init__(**kwargs)
        self.n = n
        self.v = v
        self.lambda_ref = lambda_ref
        self.lambda_short = lambda_short
        self.lambda_long = lambda_long

    @classmethod
    def from_string(cls, txt, name=None):
        txt = str(txt)
        val = [float(_) for _ in txt.split("/")]
        if len(val) == 1:
            n, = val
            v = np.inf
        elif len(val) == 2:
            n, v = val
        else:
            raise ValueError(txt)
        if name is None:
            name = "-"
        return cls(name=name, n=n, v=v)

    @functools.lru_cache(maxsize=1024)
    def refractive_index(self, wavelength):
        return (self.n + (wavelength - self.lambda_ref) /
                (self.lambda_long - self.lambda_short) *
                (1 - self.n)/self.v)

    def dict(self):
        dat = super().dict()
        dat["n"] = self.n
        dat["v"] = self.v
        if self.lambda_ref != lambda_d:
            dat["lambda_ref"] = self.lambda_ref
        if self.lambda_short != lambda_F:
            dat["lambda_short"] = self.lambda_short
        if self.lambda_long != lambda_C:
            dat["lambda_long"] = self.lambda_long
        return dat


class CoefficientsMaterial(Material):
    """Material defined by a dispersion formula and its coefficients
    (reference material.py:221)."""

    _type = "coefficients"

    def __init__(self, coefficients, typ="sellmeier", **kwargs):
        super().__init__(**kwargs)
        if typ not in DISPERSION_FORMULAS:
            import warnings
            warnings.warn(f"unknown dispersion {typ} ({self.name})")
        self.typ = typ
        self.coefficients = np.atleast_1d(coefficients).astype(float)

    def n(self, wavelength):
        """Vectorized index over wavelength (in meters)."""
        n = DISPERSION_FORMULAS[self.typ](
            np.asanyarray(wavelength)/1e-6, self.coefficients)
        if self.mirror:
            n = -n
        return n

    @functools.lru_cache(maxsize=1024)
    def refractive_index(self, wavelength):
        return float(self.n(wavelength))

    def dict(self):
        dat = super().dict()
        dat["typ"] = self.typ
        dat["coefficients"] = [float(c) for c in self.coefficients]
        return dat


Material.register(Material)
Material.register(ModelMaterial)
Material.register(AbbeMaterial)
Material.register(CoefficientsMaterial)


# built-ins (reference material.py:332-337)
vacuum = ModelMaterial(name="vacuum", catalog="basic", solid=False)
mirror = Material(name="mirror", catalog="basic", solid=False, mirror=True)
air = CoefficientsMaterial(
    name="air", catalog="basic", typ="gas", solid=False,
    coefficients=[.05792105, 238.0185, .00167917, 57.362])
basic = {m.name: m for m in (vacuum, air, mirror)}


# Built-in glass catalog: public Schott dispersion constants
# (sellmeier_squared form, n^2 - 1 = sum Bi w^2/(w^2 - Ci), w in um).
# Keys are "<book>|<page>" in refractiveindex.info naming.
GLASSES = {
    "schott-bk|n-bk7": [1.03961212, 0.00600069867, 0.231792344,
                        0.0200179144, 1.01046945, 103.560653],
    "schott-sk|n-sk16": [1.34317774, 0.00704687339, 0.241144399,
                         0.0229005, 0.994317969, 92.7508526],
    "schott-sk|n-sk2": [1.28189012, 0.0072719164, 0.257738258,
                        0.0242823527, 0.96818604, 110.377773],
    "schott-sk|n-sk4": [1.32993741, 0.00716874107, 0.228542996,
                        0.0246455892, 0.988465211, 100.886364],
    "schott-sk|n-sk5": [0.991463823, 0.00522730467, 0.495982121,
                        0.0172733646, 0.987393925, 98.3594579],
    "schott-f|n-f2": [1.39757037, 0.00995906143, 0.159201403,
                      0.0546931752, 1.2686543, 119.248346],
    "schott-f|f2": [1.34533359, 0.00997743871, 0.209073176,
                    0.0470450767, 0.937357162, 111.886764],
    "schott-f|f5": [1.3104463, 0.00958633048, 0.19603426,
                    0.0457627627, 0.96612977, 115.011883],
    "schott-lak|n-lak12": [1.17365704, 0.00577031797, 0.588992398,
                           0.0200401678, 0.978014394, 95.4873482],
    "schott-basf|n-basf64": [1.65554268, 0.0104485644, 0.17131977,
                             0.0499394756, 1.33664448, 118.961472],
    "schott-sf|n-sf5": [1.52481889, 0.011254756, 0.187085527,
                        0.0588995392, 1.42729015, 129.141675],
    "schott-sf|n-sf6": [1.77931763, 0.0133714182, 0.338149866,
                        0.0617533621, 2.08734474, 174.01759],
    "schott-sf|n-sf10": [1.62153902, 0.0122241457, 0.256287842,
                         0.0595736775, 1.64447552, 147.468793],
    "schott-sf|n-sf11": [1.73759695, 0.013188707, 0.313747346,
                         0.0623068142, 1.89878101, 155.23629],
    "schott-sf|sf1": [1.55912923, 0.0121481001, 0.284246288,
                      0.0534549042, 0.968842926, 112.174809],
    "schott-sf|sf2": [1.40301821, 0.0105795466, 0.231767504,
                      0.0493226978, 0.939056586, 112.405955],
    "schott-sf|sf4": [1.61957826, 0.0125502104, 0.339493189,
                      0.0544559822, 1.02566931, 117.652222],
    "schott-sf|sf5": [1.46141885, 0.0111826126, 0.247713019,
                      0.0508594669, 0.949995832, 112.041888],
    "schott-sf|sf10": [1.61625977, 0.0127534559, 0.259229334,
                       0.0581983954, 1.07762317, 116.60768],
    "schott-sf|sf56a": [1.70579259, 0.0133874699, 0.344223052,
                        0.0579561608, 1.09601828, 121.616024],
    "schott-bak|n-bak1": [1.12365662, 0.00644742752, 0.309276848,
                          0.0222284402, 0.881511957, 107.297751],
    "schott-bak|n-bak4": [1.28834642, 0.00779980626, 0.132817724,
                          0.0315631177, 0.945395373, 105.965875],
    "schott-baf|n-baf10": [1.5851495, 0.00926681282, 0.143559385,
                           0.0424489805, 1.08521269, 105.613573],
    "schott-balf|n-balf4": [1.31004128, 0.0079659645, 0.142038259,
                            0.0330672072, 0.964929351, 109.19732],
    "schott-k|n-k5": [1.08511833, 0.00661099503, 0.199562005,
                      0.024110866, 0.930511663, 111.982777],
    "schott-kf|n-kf9": [1.19286778, 0.00839154696, 0.0893346571,
                        0.0404010786, 0.920819805, 112.572446],
    "schott-ssk|n-ssk5": [1.59222659, 0.00920284626, 0.103520774,
                          0.0423530072, 1.05174016, 106.927374],
    "schott-lak|n-lak9": [1.46231905, 0.00724270156, 0.344399589,
                          0.0243353131, 1.15508372, 85.4686868],
    "schott-lak|n-lak22": [1.14229781, 0.00585778594, 0.535138441,
                           0.0198546147, 1.04088385, 100.834017],
    "schott-lak|n-lak33a": [1.44116999, 0.00680933877, 0.571749501,
                            0.0222291824, 1.16605226, 80.9379555],
    "schott-laf|n-laf2": [1.80984227, 0.0101711622, 0.15729555,
                          0.0442431765, 1.0930037, 100.687748],
    "schott-laf|n-laf7": [1.74028764, 0.010792558, 0.226710554,
                          0.0538626639, 1.32525548, 106.268665],
    "schott-fk|n-fk51a": [0.971247817, 0.00472301995, 0.216901417,
                          0.0153575612, 0.904651666, 168.68133],
}


@functools.lru_cache(maxsize=None)
def _glass_by_suffix():
    d = {}
    for k in GLASSES:
        d.setdefault(k.split("|")[-1], k)
    return d


def _glass_lookup(name, catalog=None):
    name = name.lower()
    key = None
    if catalog:
        key = f"{catalog.lower()}|{name}"
        if key not in GLASSES:
            key = None
    if key is None and name in GLASSES:
        key = name
    if key is None:
        key = _glass_by_suffix().get(name)
    if key is None:
        return None
    book, page = key.split("|")
    return CoefficientsMaterial(
        name=page.upper(), catalog=book.upper(),
        typ="sellmeier_squared", coefficients=GLASSES[key])


class DefaultGlass:
    def __getitem__(self, key):
        return self.get(key)

    def get(self, key):
        return Material.make(key)


all_materials = DefaultGlass()
AllGlasses = all_materials
